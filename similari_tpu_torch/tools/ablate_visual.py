"""Stage ablation of the batched VisualSORT step, on the card (the JAX
package's `tools/ablate_visual.py`).

Times stage programs that mirror the production step at the bench shape
(S scenes of D=100 objects, F=512 bf16 galleries of K=3 lanes, T=200
slots, `bench.py::box_stream` boxes over base_len=8 frames, seed 0):

  full        - the production step.  On the port that is what its bench
                runs, `parallel/mesh.py::batched_visual_step_inplace`:
                distances, cascade, auction, Kalman step and merge, the
                gallery lanes and feature history written in place by the
                merge kernel (`lane_merge_inplace`, two launches a frame),
                the small arrays by `ops/merge.py::merge_rows`;
  posonly     - the compatibility mask and `positional_weights`;
  votesonly   - the gallery distances, gates and votes (`visual_votes`) on
                features perturbed every step;
  auctiononly - `solve_voting` (the auction) on tracking-shaped positional
                weights of a warmed state, perturbed every step;
  mergeonly   - the production step's merge alone with synthetic writers:
                the two big arrays through the merge kernel, the small
                ones through `merge_rows`;
  rest        - full minus the four stages (Kalman step, best-fit claim,
                slot allocation, glue).

The stage variants read a warmed state (four production steps) that they
never write.  Eager PyTorch needs none of the JAX tool's guards against
XLA hoisting and carry copies, but the per-step perturbations stay, so
every stage does the JAX tool's work.

Timing: CUDA events around `base_len` steps of a stage (its state made
before the first event), the median of REPS runs after one warm-up
run, in ms per batch step; the host clock on the CPU.

Run: python -m similari_tpu_torch.tools.ablate_visual [scenes]
         [--device cuda|cpu]
The JAX tool's lines go to stdout, then one JSON line with ms per stage,
the rest, the merge kernel's launches in each stage and `device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import numpy as np
import torch

from ..bench import box_stream
from ..bench_interactive import device_line, log
from ..device import resolve_device
from ..eval.mot import DeviceTimer
from ..ops import assignment as asg
from ..ops import merge as mrg
from ..ops.merge_inplace import lane_merge_inplace
from ..parallel.mesh import (batched_visual_step_inplace,
                             new_batched_visual_state)
from ..trackers.sort_step import _compat
from ..trackers.state import map_tensors
from ..trackers.visual_step import (VisualConfig, positional_weights,
                                    visual_votes)
from ..utils import profiling

N_OBJECTS, FEAT_DIM, GALLERY, BASE_LEN = 100, 512, 3, 8
WARM_STEPS = 4
REPS = 3  # timed runs of each stage
CONFIG = VisualConfig(
    positional_kind="iou", visual_kind="euclidean", visual_threshold=100.0,
    visual_minimal_track_length=3, max_idle_epochs=5, assignment="auction",
    oriented=False, feature_precision="bf16")


@dataclasses.dataclass
class Inputs:
    boxes: torch.Tensor  # [base_len, S, D, 5]
    feat: torch.Tensor  # [S, D, F] f32
    ones: torch.Tensor  # [S, D] f32
    tru: torch.Tensor  # [S, D] bool


def make_inputs(scenes, dev, n_objects=N_OBJECTS, feat_dim=FEAT_DIM,
                base_len=BASE_LEN):
    """The JAX tool's boxes and features."""
    rng = np.random.default_rng(0)
    flat = box_stream(base_len, scenes * n_objects)
    feat = rng.normal(size=(scenes, n_objects, feat_dim)).astype(np.float32)
    return Inputs(
        torch.as_tensor(flat.reshape(base_len, scenes, n_objects, 5),
                        device=dev),
        torch.as_tensor(feat, device=dev),
        torch.ones((scenes, n_objects), dtype=torch.float32, device=dev),
        torch.ones((scenes, n_objects), dtype=torch.bool, device=dev))


def fresh_state(inp: Inputs, gallery=GALLERY):
    s, d, f = inp.feat.shape
    return new_batched_visual_state(s, 2 * d, 1, gallery, f,
                                    feature_dtype=torch.bfloat16,
                                    device=inp.feat.device)


def epochs(inp: Inputs, epoch: int):
    return torch.full((inp.feat.shape[0],), epoch, dtype=torch.int32,
                      device=inp.feat.device)


def warm_state(cfg, inp: Inputs, steps=WARM_STEPS):
    """The state after `steps` production steps: galleries populated,
    tracks active."""
    vstep = batched_visual_step_inplace(cfg)
    st = fresh_state(inp)
    n = inp.boxes.shape[0]
    for i in range(steps):
        st, _ = vstep(st, inp.boxes[i % n], inp.ones, inp.tru, inp.feat,
                      inp.tru, inp.ones, inp.ones, epochs(inp, 1 + i))
    return st


# ---- the stage programs: one step each ----------------------------------

def positional_stage(cfg, st, box, conf, epoch):
    """(P, valid) [S, D, T]: the compatibility mask and the positional
    weights."""
    compat = _compat(cfg, st.active, st.last_epoch, box, st.pred_box, epoch)
    return positional_weights(cfg, st, box, conf, compat)


def votes_stage(cfg, st, box, feat, gate, epoch):
    """(votes, weight) [S, D, T]: the gallery distances, gates and votes."""
    compat = _compat(cfg, st.active, st.last_epoch, box, st.pred_box, epoch)
    return visual_votes(cfg, st, feat, gate, compat)


def auction_stage(cfg, w, row_valid, col_valid):
    """The positional auction's columns [S, D] (augmented convention)."""
    return asg.solve_voting(w, cfg.new_track_threshold, row_valid, col_valid,
                            "auction")


def merge_slots(inp: Inputs, step: int):
    """The synthetic writers of merge step `step`: slots (d + step) mod T."""
    s, d, _ = inp.feat.shape
    t = 2 * d
    slot = (torch.arange(d, dtype=torch.int32, device=inp.feat.device)
            + step) % t
    return slot.expand(s, d)


def merge_stage(st, box, conf, src, slot):
    """The production step's merge with writers `slot` [S, D] (every row
    valid, gallery lane 0, history row 0): the lanes and the history in
    place by the merge kernel, the small arrays by merge_rows.  Returns
    the new state (its `feats` and `hist_feat` are the input's, written)."""
    s, t, k, f = st.feats.shape
    h = st.hist_feat.shape[2]
    d = slot.shape[1]
    one = torch.ones((s, d), dtype=torch.int32, device=slot.device)
    lane_merge_inplace(st.feats.view(s, t * k, f), src, slot * k, one)
    lane_merge_inplace(st.hist_feat.view(s, t * h, f), src, slot * h, one)
    index = mrg.write_index(slot, one.bool(), t)
    return dataclasses.replace(
        st,
        pred_box=mrg.merge_rows(st.pred_box, box, index),
        obs_box=mrg.merge_rows(st.obs_box, box, index),
        conf=mrg.merge_rows(st.conf, conf, index),
        length=mrg.merge_rows(st.length, one, index),
        track_id=mrg.merge_rows(st.track_id, slot, index),
        feat_quality=mrg.merge_rows(
            st.feat_quality, torch.zeros((s, d, k), device=slot.device),
            index),
        collected=mrg.merge_rows(st.collected, one, index))


# ---- timing ---------------------------------------------------------------

def time_stage(dev, start, body, steps, reps):
    """Median ms per step of `reps` runs of `body(state, i)` for i < steps,
    each from `start()` (outside the timed window), after a warm-up run."""
    times = []
    for rep in range(reps + 1):
        state = start()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with DeviceTimer(dev) as timer:
            for i in range(steps):
                state = body(state, i)
        if rep:
            times.append(timer.seconds * 1e3 / steps)
    return statistics.median(times)


def stage_programs(cfg, inp: Inputs):
    """{stage: (start, body)}: each body runs one step of its stage."""
    vstep = batched_visual_step_inplace(cfg)
    warm = map_tensors(torch.clone, warm_state(cfg, inp))
    p0, v0 = positional_stage(cfg, warm, inp.boxes[0], inp.ones,
                              epochs(inp, 5))
    w0 = torch.where(v0, p0, 0.0)
    col_open = torch.ones(warm.active.shape, dtype=torch.bool,
                          device=w0.device)
    src0 = inp.feat[0].to(torch.bfloat16).expand(inp.feat.shape).contiguous()
    zero = lambda: torch.zeros((), device=inp.feat.device)  # noqa: E731

    def full(st, i):
        st, _ = vstep(st, inp.boxes[i], inp.ones, inp.tru, inp.feat,
                      inp.tru, inp.ones, inp.ones, epochs(inp, 1 + i))
        return st

    def pos(tot, i):
        p, v = positional_stage(cfg, warm, inp.boxes[i], inp.ones,
                                epochs(inp, 1 + i))
        return tot + p.sum() + v.sum()

    def votes(tot, i):
        f_i = inp.feat * (1.0 + 1e-6 * i)
        n, w = votes_stage(cfg, warm, inp.boxes[i], f_i, inp.tru,
                           epochs(inp, 1 + i))
        return tot + n.sum() + w.sum()

    def auction(tot, i):
        col = auction_stage(cfg, w0 * (1.0 + 1e-5 * i), inp.tru, col_open)
        return tot + col.sum()

    def merge(st, i):
        return merge_stage(st, inp.boxes[i], inp.ones, src0,
                           merge_slots(inp, i))

    fresh = lambda: fresh_state(inp)  # noqa: E731
    return {"full": (fresh, full), "posonly": (zero, pos),
            "votesonly": (zero, votes), "auctiononly": (zero, auction),
            "mergeonly": (fresh, merge)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenes", type=int, nargs="?", default=256)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}")
    scenes = args.scenes
    inp = make_inputs(scenes, dev)

    times, launches = {}, {}
    for name, (start, body) in stage_programs(CONFIG, inp).items():
        merges = profiling.counter("merge_inplace.launches")
        dt = time_stage(dev, start, body, BASE_LEN, REPS)
        times[name] = dt
        launches[name] = profiling.counter("merge_inplace.launches") - merges
        print(f"{name:12s}: {dt:8.3f} ms/step "
              f"({dt * 1e3 / scenes:7.2f} us/scene-frame)", flush=True)

    rest = (times["full"] - times["posonly"] - times["votesonly"]
            - times["auctiononly"] - times["mergeonly"])
    print("--- breakdown (per batch step) ---")
    print(f"positional stage : {times['posonly']:8.3f} ms")
    print(f"gallery stage    : {times['votesonly']:8.3f} ms")
    print(f"auction          : {times['auctiononly']:8.3f} ms")
    print(f"state merge      : {times['mergeonly']:8.3f} ms")
    print(f"KF+bestfit+rest  : {rest:8.3f} ms")
    print(json.dumps({"metric": "visual_step_stage_ms", "scenes": scenes,
                      "ms_per_step": {k: round(v, 5)
                                      for k, v in times.items()},
                      "rest_ms": round(rest, 5),
                      "merge_launches": launches, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
