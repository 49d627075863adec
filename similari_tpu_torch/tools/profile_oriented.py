"""Where the oriented-500 interactive `Sort` call spends its time (the JAX
package's `tools/profile_oriented.py`), on both of the port's engines.

The stream is `bench_interactive.py`'s oriented-500 workload: 500 boxes
of 30-60 px, uniform in 2000 x 2000, angles in [0, 1), +-2 px of motion a
frame (seed 1).

Host engine (`engine="host"`, the C++ step of `csrc/sortstep.cpp`), as
the JAX tool splits it:
  1. the whole `Sort.predict_arrays` call, median ms;
  2. the native `SortStepSession.step` alone (1 - 2 is the Python
     wrapper);
  3. the same zero-angle stream through an aligned session;
  4. that stream through a session forced to the oriented path (3 - 4
     is the clip's surcharge with the same pairs: the clip does the same
     work at angle 0);
  5. a NumPy replica of the step's grid scan counts its pair-weight
     calls, giving ns per rotated IoU.

Device engine (`engine="device"`, the general step on the card), new in
the port: the same oriented 500-box call's CUDA-event ms (median), the
clip kernel's device ms per launch and the device's busy ms, kernel
launches and idle share per call from `torch.profiler` over `--profiled`
calls, and the clip kernel's launches per call from its wrapper's
counter (`clip.launches` of `utils/profiling.py`).

Run: python -m similari_tpu_torch.tools.profile_oriented
         [--device cuda|cpu] [--reps N] [--profiled N]
`--device cpu` runs the device engine's plain versions on the host (no
profile).  One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import native
from ..bench_interactive import call_ms, device_line, log
from ..device import resolve_device
from ..trackers import PositionalMetricType, Sort
from ..utils import profiling


OBJECTS = 500  # boxes a call (the oriented-500 row)


def make_stream(n, oriented, seed=1):
    """frame() -> (boxes [n, 5], conf [n]) of the next frame: the JAX
    tool's stream, bit for bit."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, 1.0, (n,)).astype(np.float32) if oriented else None

    def frame():
        nonlocal xy
        xy = xy + rng.uniform(-2, 2, xy.shape).astype(np.float32)
        boxes = np.zeros((n, 5), np.float32)
        boxes[:, :2] = xy
        if oriented:
            boxes[:, 2] = ang
        boxes[:, 3] = wh[:, 0] / wh[:, 1]
        boxes[:, 4] = wh[:, 1]
        return boxes, np.ones((n,), np.float32)

    return frame


def timed(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _tracker(**kw):
    return Sort(shards=1, bbox_history=1, max_idle_epochs=5,
                method=PositionalMetricType.iou(0.3), **kw)


def pair_weight_calls(state, boxes):
    """(active recent tracks, pair-weight calls) of the step's grid scan
    for detections `boxes` against the state's tracks (NumPy replica)."""
    active = np.asarray(state.active).astype(bool)
    last = np.asarray(state.last_epoch)
    # the step scans tracks that are active and updated within the idle
    # limit
    act = active & ((int(last.max()) - last) <= 5)
    pred = np.asarray(state.pred_box)[act]
    r = np.sqrt((pred[:, 3] * pred[:, 4]) ** 2 + pred[:, 4] ** 2) / 2
    rmax = max(float(r.max()), 1.0)
    cell = max(rmax, float(np.ptp(pred[:, 0])) / 1022.0,
               float(np.ptp(pred[:, 1])) / 1022.0)
    det_r = np.sqrt((boxes[:, 3] * boxes[:, 4]) ** 2 + boxes[:, 4] ** 2) / 2
    span = ((det_r + rmax) / cell).astype(np.int32) + 1
    tcx = ((pred[:, 0] - pred[:, 0].min()) / cell).astype(np.int64)
    tcy = ((pred[:, 1] - pred[:, 1].min()) / cell).astype(np.int64)
    dcx = ((boxes[:, 0] - pred[:, 0].min()) / cell).astype(np.int64)
    dcy = ((boxes[:, 1] - pred[:, 1].min()) / cell).astype(np.int64)
    hits = ((np.abs(tcx[None, :] - dcx[:, None]) <= span[:, None])
            & (np.abs(tcy[None, :] - dcy[:, None]) <= span[:, None]))
    return int(act.sum()), int(hits.sum())


def host_split(n: int, reps: int) -> dict:
    """The JAX tool's split of the host engine's call."""
    out = {}
    for name, oriented in (("oriented", True), ("aligned", False)):
        frame = make_stream(n, oriented)
        tracker = _tracker(engine="host", device="cpu")
        for _ in range(5):
            tracker.predict_arrays(0, *frame())
        out[f"{name}_full_ms"] = round(
            timed(lambda: tracker.predict_arrays(0, *frame()), reps), 4)
        store = tracker._get_store(0)
        epoch = [1000]

        def step(session):
            epoch[0] += 1
            b, c = frame()
            session.step(b, c, epoch[0], 10 ** 6)

        out[f"{name}_native_ms"] = round(
            timed(lambda: step(store.session), reps), 4)
        if not oriented:
            forced = native.SortStepSession(
                dataclasses.replace(tracker._cfg, oriented=True),
                store.state)
            out["aligned_forced_oriented_native_ms"] = round(
                timed(lambda: step(forced), reps), 4)
            out["tracks_active"], out["pair_weight_calls"] = \
                pair_weight_calls(store.state, frame()[0])
    out["python_wrapper_ms"] = round(
        out["oriented_full_ms"] - out["oriented_native_ms"], 4)
    out["clip_surcharge_ms"] = round(
        out["aligned_forced_oriented_native_ms"] - out["aligned_native_ms"],
        4)
    if out["pair_weight_calls"]:
        out["implied_ns_per_rotated_iou"] = round(
            out["clip_surcharge_ms"] * 1e6 / out["pair_weight_calls"], 1)
    return out


def device_profile(fn, calls: int) -> dict:
    """torch.profiler over `calls` calls of fn: per call, the device's
    busy ms and kernel launches, and the clip kernel's device ms per
    launch."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = profiling.device_events(prof)
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]
    clips = [e.time_range.elapsed_us() for e in kernels
             if "clip_pairs" in e.name]
    return {
        "device_busy_ms_per_call": round(sum(
            e.time_range.elapsed_us() for e in events) / 1e3 / calls, 4),
        "kernels_per_call": round(len(kernels) / calls, 2),
        "copies_per_call": round((len(events) - len(kernels)) / calls, 2),
        "clip_device_ms_per_launch": (round(float(np.mean(clips)) / 1e3, 5)
                                      if clips else None),
    }


def device_split(dev: torch.device, n: int, reps: int,
                 profiled: int) -> dict:
    """The device engine's oriented call: CUDA-event ms, the clip
    kernel's launches per call, and on the card its profile."""
    frame = make_stream(n, True)
    tracker = _tracker(engine="device", device=dev)
    for _ in range(5):
        tracker.predict_arrays(0, *frame())
    clips = profiling.counter("clip.launches")
    times = [call_ms(dev, lambda: tracker.predict_arrays(0, *frame()))
             for _ in range(reps)]
    out = {"device_call_ms": round(statistics.median(times), 4),
           "device_call_spread_ms": [round(min(times), 4),
                                     round(max(times), 4)],
           "clip_launches_per_call":
               (profiling.counter("clip.launches") - clips) / reps,
           "device_capacity": int(tracker._get_store(0).state.capacity)}
    if dev.type == "cuda":
        out.update(device_profile(
            lambda: tracker.predict_arrays(0, *frame()), profiled))
        out["idle_share"] = round(
            1.0 - out["device_busy_ms_per_call"] / out["device_call_ms"], 4)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profiled", type=int, default=16,
                    help="device calls under torch.profiler")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    out = {"objects": OBJECTS, **host_split(OBJECTS, args.reps),
           **device_split(dev, OBJECTS, args.reps, args.profiled)}
    for k, v in out.items():
        log(f"{k}: {v}")
    print(json.dumps({"metric": "oriented_500_cost_split", "device": card,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
