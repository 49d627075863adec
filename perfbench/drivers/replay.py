"""Offline replay: recorded sequences (detections and ReID features), one
after another, each from a fresh state, through the port's fused
VisualSORT scan (`ops/fused_visual.py::fused_visual_scan`: per chunk the
gallery products, then the fused frame loop), the ids, slots, voting
types and final state of each read back to the host before the next.

The sequences are recorded at set-up, on the device, as the detector's
output would be on disk: boxes, confidences and which identity each row
shows.  A sequence's features are made when it is replayed (its part of
the window is the generator's share); a window that replays the whole
pool starts it again, with fresh feature noise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import harness
from perfbench.drivers.stream import state_arrays
from perfbench.reference import check as chk
from perfbench.traffic import Scenes, record

SCAN_SPAN = "perfbench.scan"


def alive_per_frame(ids: np.ndarray, valid: np.ndarray, idle: int):
    """Tracks alive at the start of each frame (last seen within `idle`
    frames), from a sequence's ids [L, D]."""
    last: Dict[int, int] = {}
    out = np.zeros(len(ids), np.int64)
    for f in range(len(ids)):
        out[f] = sum(1 for e in last.values() if f - e <= idle)
        for i in ids[f][valid[f]]:
            last[int(i)] = f
    return out


class Driver:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device,
                 control: Optional[str] = None):
        self.cell, self.seed, self.dev, self.control = cell, seed, device, control
        self.notes: Dict[str, float] = {}
        self.kept: Dict[int, Dict] = {}

    def setup(self) -> None:
        from similari_tpu_torch.ops.fused_visual import fused_visual_scan
        from similari_tpu_torch.trackers.visual_state import new_visual_state

        cell, mix, dev = self.cell, self.cell.mix, self.dev
        if dev.type == "cuda":
            from similari_tpu_torch import _build
            t0 = time.perf_counter()
            _build.library()
            self.notes["build_s"] = time.perf_counter() - t0
        self.cfg = harness.program_config(cell)
        self.fdtype = torch.float32
        if self.control == "program_bf16":
            self.cfg = dataclasses.replace(self.cfg, feature_precision="bf16")
            self.fdtype = torch.bfloat16
        self.scan, self.new_state = fused_visual_scan, new_visual_state
        b, self.chunk = mix["sequences"], mix["chunk"]
        lmin, lmax = mix["length"]
        self.dpad, f = mix["dpad"], cell.config["feature_dim"]
        versions = lmax // mix["lifetime"][0] + 2
        self.gen = Scenes(mix, b, self.seed, dev, f, versions=versions)
        c = self.chunk
        # the fixed set's lengths, in the seed's order
        self.lengths = (torch.randint(-(-lmin // c), lmax // c + 1, (b,),
                                      generator=self.gen.g, device=dev)
                        [self.gen.perm] * c).tolist()
        self.pool = record(self.gen, max(self.lengths))
        pick = torch.Generator().manual_seed(int(self.seed))
        self.sample = set(torch.randperm(b, generator=pick)[
            :mix["check_sequences"]].tolist())
        self.next = 0
        for _ in range(mix["warm_sequences"]):
            self._sequence(self.next % b, keep=False)
            self.next += 1
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _inputs(self, b: int):
        n = self.lengths[b]
        p = self.pool
        x = {k: p[k][:n, b].contiguous() for k in ("box", "conf", "valid",
                                                    "qual", "src", "version")}
        x["feat"] = self.gen.sequence_features(b, x["src"], x["version"])
        return x

    def _sequence(self, b: int, keep: bool):
        """Replay pool sequence b; returns (frames, generator s, overflow
        frames, host ids, host valid)."""
        cfg, mix = self.cell.config, self.cell.mix
        t0 = time.perf_counter()
        with record_function("perfbench.generate"):
            x = self._inputs(b)
            state = self.new_state(mix["capacity"], cfg["history"],
                                   cfg["gallery"], cfg["feature_dim"],
                                   feature_dtype=self.fdtype, device=self.dev)
            ones = torch.ones_like(x["conf"])
        self._sync()
        t1 = time.perf_counter()
        with record_function(SCAN_SPAN):
            st, (ids, slots, pred, vt, newf, _len, ovf) = self.scan(
                self.cfg, state, x["box"], x["conf"], x["valid"], x["feat"],
                x["valid"], x["qual"], ones, 1, self.chunk)
            self._sync()  # the span ends when the scan's device work does
        with record_function("perfbench.readback"):
            host = torch.cat([ids, slots, vt, ovf[:, None].expand_as(ids)
                              .to(torch.int32)], 1).cpu().numpy()
            final = state_arrays(st, True)
        n = ids.shape[0]
        d = ids.shape[1]
        if keep:
            # device tensors: made host arrays after the window
            self.kept[b] = dict(x=x, is_new=newf, pred=pred,
                                prog=dict(ids=host[:, :d],
                                          slots=host[:, d:2 * d],
                                          vt=host[:, 2 * d:3 * d]),
                                state=final)
        return (n, t1 - t0, int(host[:, -1].sum()), host[:, :d],
                x["valid"].cpu().numpy())

    def window(self, seconds: float, trace: bool) -> Dict:
        mix, b = self.cell.mix, self.cell.mix["sequences"]
        idle = self.cell.config["settings"]["max_idle_epochs"]
        frames = failed = 0
        gen_s = 0.0
        seq_s: List[float] = []
        prof, work = None, []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            now = time.perf_counter() - start
            if trace and prof is None and now >= seconds / 2:
                with harness.profiled() as h:
                    done = []
                    for _ in range(mix["trace_sequences"]):
                        j = self.next % b
                        self.next += 1
                        done.append(self._sequence(j, keep=False))
                prof = h.prof
                for n, g, ovf, ids, valid in done:
                    frames, failed, gen_s = frames + n, failed + ovf, gen_s + g
                    work.append((valid.sum(1), alive_per_frame(ids, valid,
                                                               idle)))
                continue
            j = self.next % b
            self.next += 1
            t0 = time.perf_counter()
            n, g, ovf, _, _ = self._sequence(
                j, keep=j in self.sample and j not in self.kept)
            seq_s.append(time.perf_counter() - t0)
            frames, failed, gen_s = frames + n, failed + ovf, gen_s + g
        window_s = time.perf_counter() - start
        run = dict(window_s=window_s, frames=frames, attempted=frames,
                   failed=failed, seq_s=seq_s, gen_share=gen_s / window_s,
                   profile=None,
                   shape=dict(dpad=self.dpad, capacity=mix["capacity"],
                              chunk=self.chunk, visual=True,
                              feature_dim=self.cell.config["feature_dim"],
                              gallery=self.cell.config["gallery"]))
        if prof is not None:
            run["profile"] = harness.reduce_profile(prof, (SCAN_SPAN,))
            run["work"] = work
        return run

    def check(self) -> chk.Readings:
        """Hold each sampled sequence that the window replayed to the
        reference (a sampled sequence the window never reached is
        replayed now, after the window)."""
        for b in sorted(self.sample - set(self.kept)):
            self._sequence(b, keep=True)
        self.pool = self.gen = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_cfg = self.cell.ref_config()
        tasks = []
        for b in sorted(self.kept):
            k = self.kept[b]
            x = {n: k["x"][n].cpu().numpy()
                 for n in ("box", "conf", "valid", "qual", "feat")}
            frames = [dict({n: v[i] for n, v in x.items()},
                           fvalid=x["valid"][i])
                      for i in range(len(x["box"]))]
            if self.control == "reference_bf16":
                tasks.append((ref_cfg, self.dpad, frames, None, None))
                continue
            prog = dict(k["prog"], is_new=k["is_new"].cpu().numpy(),
                        pred=k["pred"].cpu().numpy())
            tasks.append((ref_cfg, self.dpad, frames, prog, k["state"]))
        return chk.compare_all(tasks)
