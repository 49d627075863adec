"""Closed-loop streams: S camera scenes stepped together, one frame at a
time, through the port's batched step
(`parallel/mesh.py::batched_visual_step_inplace` for VisualSORT,
`batched_sort_step` for SORT), each frame's ids (and voting types) back in
host memory before the next frame is made.

A step's latency runs from the moment its inputs are ready on the device
to the moment its ids are in host memory; the traffic generator's time per
frame lies outside it and inside the window's rate.  A sample of scenes
drawn from the seed (`sample_scenes`) keeps its inputs and outputs on the
device for the check after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import harness
from perfbench.reference import check as chk
from perfbench.traffic import Scenes

STEP_SPAN = "perfbench.step"


def state_arrays(state, visual: bool) -> Dict[str, np.ndarray]:
    """A program state of one scene as host arrays by the reference's
    names (history depth 1)."""
    def host(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()

    out = {f: host(getattr(state.kf, f)) for f in chk.KF_FIELDS}
    for f in ("pred_box", "obs_box", "conf", "active", "last_epoch",
              "length", "track_id"):
        out[f] = host(getattr(state, f))
    if visual:
        for f in ("feats", "feat_quality", "feat_valid", "collected",
                  "voting_type"):
            out[f] = host(getattr(state, f))
        out["hist_feat"] = host(state.hist_feat[..., 0, :])
        out["hist_feat_valid"] = host(state.hist_feat_valid[..., 0])
    return out


def sample_scenes(s: int, n: int, seed: int) -> torch.Tensor:
    """n of s scenes drawn from the seed, one from each of n equal strata
    of the batch's index, the q-th of parity q % 2 where its stratum
    allows: a step that leaves out the upper or lower half of the scenes,
    or every other one, leaves out a sampled scene."""
    g = torch.Generator().manual_seed(int(seed))
    out = []
    for q in range(n):
        lo, hi = q * s // n, (q + 1) * s // n
        cand = torch.arange(lo, hi)
        if len(cand) > 1:
            cand = cand[cand % 2 == q % 2]
        out.append(int(cand[torch.randint(len(cand), (1,), generator=g)]))
    return torch.tensor(out)


class Driver:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device,
                 control: Optional[str] = None):
        self.cell, self.seed, self.dev, self.control = cell, seed, device, control
        self.kept: List[Dict[str, torch.Tensor]] = []
        self.notes: Dict[str, float] = {}

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from similari_tpu_torch.parallel import mesh

        cell, mix, dev = self.cell, self.cell.mix, self.dev
        if dev.type == "cuda":
            from similari_tpu_torch import _build
            t0 = time.perf_counter()
            _build.library()
            self.notes["build_s"] = time.perf_counter() - t0
        cfg = harness.program_config(cell)
        fdtype = torch.float32
        if self.control == "program_bf16":
            cfg = dataclasses.replace(cfg, feature_precision="bf16")
            fdtype = torch.bfloat16
        s, self.dpad, cap = mix["scenes"], mix["dpad"], mix["capacity"]
        self.s = s
        self.visual = cell.visual
        f = cell.config.get("feature_dim", 0)
        self.gen = Scenes(mix, s, self.seed, dev, f)
        self.sample = sample_scenes(s, mix["check_scenes"], self.seed).to(dev)
        # the sample's frames pile up through the window: from a pool of
        # their own they never split the blocks the step's temporaries
        # come back to, which would send the step to cudaMalloc
        self.pool = torch.cuda.MemPool() if dev.type == "cuda" else None
        if self.visual:
            self.state = mesh.new_batched_visual_state(
                s, cap, cell.config["history"], cell.config["gallery"], f,
                feature_dtype=fdtype, device=dev)
            self.vstep = mesh.batched_visual_step_inplace(cfg)
            self.ones = torch.ones((s, self.dpad), device=dev)
        else:
            self.state = mesh.new_batched_state(
                s, cap, cell.config["history"], device=dev)
            self.vstep = mesh.batched_sort_step(cfg)
        width = (2 if self.visual else 1) * self.dpad + 1
        self.host = torch.empty((s, width), dtype=torch.int32,
                                pin_memory=dev.type == "cuda")
        self.epoch = 0
        for _ in range(mix["warm_frames"]):
            self._step()
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- one frame ----------------------------------------------------------

    def _step(self, counts: Optional[list] = None):
        """One frame; returns (generator s, step s, host call s, overflowing
        scenes)."""
        self.epoch += 1
        t0 = time.perf_counter()
        with record_function("perfbench.generate"):
            fr = self.gen.step()
            ep = torch.full((self.s,), self.epoch, dtype=torch.int32,
                            device=self.dev)
        if counts is not None:
            with record_function("perfbench.count"):
                idle = self.cell.config["settings"]["max_idle_epochs"]
                alive = self.state.active & (
                    ep[:, None] - self.state.last_epoch <= idle)
                counts.append((fr.valid.sum(-1), alive.sum(-1)))
        self._sync()
        t1 = time.perf_counter()
        with record_function(STEP_SPAN):
            if self.visual:
                self.state, out = self.vstep(
                    self.state, fr.box, fr.conf, fr.valid, fr.feat,
                    fr.fvalid, fr.qual, self.ones, ep)
            else:
                self.state, out = self.vstep(self.state, fr.box, fr.conf,
                                             fr.valid, ep)
            if counts is not None:
                # a traced step's span ends when its device work does
                self._sync()
        t2 = time.perf_counter()
        with record_function("perfbench.readback"):
            cols = [out.track_id] + ([out.voting_type] if self.visual else [])
            cols.append(out.overflow[:, None].to(torch.int32))
            self.host.copy_(torch.cat(cols, 1), non_blocking=True)
            self._sync()
        t3 = time.perf_counter()
        overflow = int(self.host[:, -1].sum())
        with record_function("perfbench.sample"), (
                torch.cuda.use_mem_pool(self.pool) if self.pool is not None
                else contextlib.nullcontext()):
            sel = self.sample
            keep = {k: getattr(fr, k).index_select(0, sel)
                    for k in ("box", "conf", "valid", "qual")}
            if self.visual:
                keep["feat"] = fr.feat.index_select(0, sel)
                keep["fvalid"] = fr.fvalid.index_select(0, sel)
                keep["vt"] = out.voting_type.index_select(0, sel)
            keep.update(ids=out.track_id.index_select(0, sel),
                        slots=out.slot.index_select(0, sel),
                        is_new=out.is_new.index_select(0, sel),
                        pred=out.pred_box.index_select(0, sel))
            self.kept.append(keep)
        return t1 - t0, t3 - t1, t2 - t1, overflow

    # -- the window -------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> Dict:
        mix = self.cell.mix
        gen_s, step_s, call_s = [], [], []
        failed = frames = 0
        prof = None
        counts: list = []
        start = time.perf_counter()
        while True:
            now = time.perf_counter() - start
            if now >= seconds:
                break
            if trace and prof is None and now >= seconds / 2:
                with harness.profiled() as h:
                    for _ in range(mix["trace_steps"]):
                        g, st, _, ovf = self._step(counts)
                        gen_s.append(g)
                        step_s.append(st)
                        failed += ovf
                        frames += 1
                prof = h.prof
                continue
            g, st, c, ovf = self._step()
            gen_s.append(g)
            step_s.append(st)
            call_s.append(c)
            failed += ovf
            frames += 1
        window_s = time.perf_counter() - start
        run = dict(window_s=window_s, frames=frames,
                   scene_frames=frames * self.s, attempted=frames * self.s,
                   failed=failed, step_s=step_s, call_s=call_s,
                   gen_share=sum(gen_s) / window_s, profile=None,
                   shape=dict(scenes=self.s, dpad=self.dpad,
                              capacity=mix["capacity"], visual=self.visual,
                              feature_dim=self.cell.config.get(
                                  "feature_dim", 0),
                              gallery=self.cell.config.get("gallery", 0)))
        if prof is not None:
            run["profile"] = harness.reduce_profile(prof, (STEP_SPAN,))
            run["work"] = [(v.cpu().numpy(), a.cpu().numpy())
                           for v, a in counts]
        return run

    # -- the check --------------------------------------------------------

    def check(self) -> chk.Readings:
        """Free the program's state, then hold each sampled scene's frames
        to the reference."""
        final = None
        if self.control != "reference_bf16":
            from similari_tpu_torch.trackers.state import map_tensors
            sub = map_tensors(lambda a: a.index_select(0, self.sample),
                              self.state)
            final = [state_arrays(map_tensors(lambda a: a[j], sub),
                                  self.visual)
                     for j in range(len(self.sample))]
        del self.state
        self.gen = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        kept = {k: torch.stack([x[k] for x in self.kept]).cpu()
                for k in self.kept[0]}
        self.kept = []
        ref_cfg = self.cell.ref_config()
        tasks = []
        for j in range(len(self.sample)):
            frames = [{k: kept[k][i, j].numpy()
                       for k in ("box", "conf", "valid", "qual", "feat",
                                 "fvalid") if k in kept}
                      for i in range(kept["box"].shape[0])]
            if self.control == "reference_bf16":
                tasks.append((ref_cfg, self.dpad, frames, None, None))
                continue
            prog = {k: kept[k][:, j].numpy()
                    for k in ("ids", "slots", "is_new", "pred", "vt")
                    if k in kept}
            tasks.append((ref_cfg, self.dpad, frames, prog, final[j]))
        return chk.compare_all(tasks)

