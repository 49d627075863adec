"""Scenes one after another through the fused VisualSORT kernel, on the card
(the JAX package's `tools/experiment_pallas_batch.py`).

The JAX tool asks whether the fused single-scene kernel can serve batch
workloads: n independent single-scene `pallas_call`s in one jit.  Here
each frame chunk of n scenes is n calls of `ops/fused_visual.py::
fused_visual_chunk` on one stream, i.e. n `gallery_dots` launches and n
`fused_visual_kernel` launches, one cluster each: the baseline a fused
kernel with a scene axis would have to beat.  The shape and
inputs are the JAX tool's: chunk 32, D=100 detections, T=400 slots, K=3
lanes, F=512, the bf16 euclidean configuration, scene i's random walk and
features from seed 7 + i; every chunk runs from the state the last one
left at epoch 1, as the JAX tool's loop does.  The shape is checked first
(`check_visual_shape`); a refusal is raised with its reason.

Timing: CUDA events around ITERS chunks of every scene (the states made
before the first event), the median of REPS runs after one warm-up
chunk; the host clock on the CPU.  Each scene's ids in its first
chunk must equal that scene's chunk run alone through the plain version
(`fused_visual_chunk_plain`): a difference is exit code 1.

Run: python -m similari_tpu_torch.tools.experiment_pallas_batch
         [--device cuda|cpu]
The JAX tool's us/frame lines go to stdout, then one JSON line with the
rates by scene count, the launches of both wrappers, the ids check and
`device`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..bench_interactive import device_line, log
from ..device import resolve_device
from ..eval.mot import DeviceTimer
from ..ops import fused_visual as fv
from ..trackers.visual_state import new_visual_state
from ..trackers.visual_step import VisualConfig
from ..utils import profiling

CHUNK, D, T, K, F = 32, 100, 400, 3, 512
SCENES = (1, 2)  # scenes a chunk, one launch of each kernel a scene
ITERS, REPS = 8, 3  # chunks of a timed run, timed runs
CONFIG = VisualConfig(
    positional_kind="iou", visual_kind="euclidean", visual_threshold=100.0,
    visual_minimal_track_length=3, max_idle_epochs=5, assignment="auction",
    oriented=False, feature_precision="bf16")


def scene_inputs(seed, dev, chunk=CHUNK, d=D, f=F):
    """The JAX tool's chunk inputs of one scene: (box, conf, valid, feat,
    feat_valid, quality, own_area), a random walk of d boxes with one
    feature each, repeated every frame."""
    r = np.random.default_rng(seed)
    box = np.zeros((chunk, d, 5), np.float32)
    xy = r.uniform(0, 1000, (d, 2))
    for s in range(chunk):
        xy += r.uniform(-2, 2, xy.shape)
        box[s, :, 0] = xy[:, 0]
        box[s, :, 1] = xy[:, 1]
        box[s, :, 3] = 0.5
        box[s, :, 4] = 30.0
    feat = np.broadcast_to(
        r.normal(size=(1, d, f)).astype(np.float32), (chunk, d, f)).copy()
    ones = torch.ones((chunk, d), dtype=torch.float32, device=dev)
    ib = torch.ones((chunk, d), dtype=torch.int32, device=dev)
    return (torch.as_tensor(box, device=dev), ones, ib,
            torch.as_tensor(feat, device=dev), ib, ones, ones)


def fresh_state(dev, t=T, k=K, f=F):
    return fv.state_to_tuple(new_visual_state(t, 1, k, f, device=dev))


def step(states, all_args, cfg=CONFIG):
    """One chunk of every scene, one `fused_visual_chunk` call each; returns
    the new states and each scene's ids [C, D]."""
    outs = [fv.fused_visual_chunk(cfg, st, *args, 1)
            for st, args in zip(states, all_args)]
    return [o[0] for o in outs], [o[1] for o in outs]


def lone_ids(dev, all_args, cfg=CONFIG, t=T, k=K, f=F):
    """Each scene's first-chunk ids run alone through the plain version."""
    return [fv.fused_visual_chunk_plain(cfg, fresh_state(dev, t, k, f),
                                        *args, 1)[1]
            for args in all_args]


def measure(dev, n_scenes, iters, reps, shape=(CHUNK, D, T, K, F)):
    """(median seconds per frame of n scenes, the first chunk's ids per
    scene, launches of both wrappers over the timed runs)."""
    chunk, d, t, k, f = shape
    all_args = [scene_inputs(7 + i, dev, chunk, d, f)
                for i in range(n_scenes)]
    _, first = step([fresh_state(dev, t, k, f) for _ in all_args], all_args)
    names = {"fused_visual": "fused_visual.launches",
             "gallery_dots": "gallery_dots.launches"}
    before = {k: profiling.counter(n) for k, n in names.items()}
    times = []
    for _ in range(reps):
        states = [fresh_state(dev, t, k, f) for _ in all_args]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with DeviceTimer(dev) as timer:
            for _ in range(iters):
                states, _ids = step(states, all_args)
        times.append(timer.seconds / (iters * chunk))
    launches = {k: profiling.counter(n) - before[k]
                for k, n in names.items()}
    return statistics.median(times), first, launches, all_args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}")
    fv.check_visual_shape(D, T, K)  # raises with the kernel's reason

    rows, same = {}, True
    for n in SCENES:
        per_frame, first, launches, all_args = measure(dev, n, ITERS, REPS)
        alone = lone_ids(dev, all_args)
        equal = [bool(torch.equal(a, b.to(a.device)))
                 for a, b in zip(first, alone)]
        same = same and all(equal)
        print(f"fused x{n} scenes/step: {per_frame * 1e6:.1f} us/frame, "
              f"{per_frame / n * 1e6:.1f} us/scene-frame "
              f"({n / per_frame:.0f} scene-fps); launches {launches}; "
              f"ids equal to each scene alone (plain): {equal}", flush=True)
        rows[f"x{n}"] = {"us_per_frame": round(per_frame * 1e6, 3),
                         "us_per_scene_frame": round(per_frame / n * 1e6, 3),
                         "scene_fps": round(n / per_frame, 2),
                         "launches": launches, "ids_equal_alone": equal}
    print(json.dumps({"metric": "fused_visual_scenes_sequential",
                      "chunk": CHUNK, "rows": rows, "ids_equal_alone": same,
                      "device": card}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
