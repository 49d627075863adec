#!/usr/bin/env python3
"""Where the time of the port's general SORT step goes, on one NVIDIA GPU.

Runs `similari_tpu_torch.trackers.sort_step.sort_scan` on the two streams
`chip_smoke.py` drives it with: oriented IoU at D=500 detections, T=2000
slots (bench.py's `sort_iou_oriented_500`, the clip kernel's sorted path)
and Mahalanobis at D=128 rows for 100 objects, T=512 (phase 8's runner
shape).  For each it prints, per frame: the CUDA-event time, the device's
busy time (sum of kernel times under `torch.profiler`) and so its idle
share, the auction rounds, the kernel launches, and the kernels that take
the most device time.

Usage: python3 tools/profile_torch_sort.py [--frames N]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from similari_tpu_torch.eval.mot import DeviceTimer, ltwh_to_vec5  # noqa: E402
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan  # noqa: E402
from similari_tpu_torch.trackers.state import new_sort_state  # noqa: E402
from similari_tpu_torch.utils import profiling  # noqa: E402


def maha_stream(frames, seed):
    """phase 8's sequence as padded [S, 128] tensors, confidence 1."""
    dets, _ = cs.synthetic_sequence(frames, seed)
    box = np.zeros((frames, cs.D, 5), np.float32)
    valid = np.zeros((frames, cs.D), bool)
    for s, f in enumerate(sorted(dets)):
        d = np.asarray(dets[f], np.float32)
        box[s, :len(d)] = ltwh_to_vec5(d)
        valid[s, :len(d)] = True
    return box, np.ones((frames, cs.D), np.float32), valid


def profile(name, cfg, t, box, conf, valid, dev):
    steps = box.shape[0]
    box, conf, valid = (torch.as_tensor(x, device=dev)
                        for x in (box, conf, valid))
    st0 = new_sort_state(t, 1, device=dev)
    sort_scan(cfg, st0, box[:2], conf[:2], valid[:2], 1)  # warm-up
    # the auction's rounds, counted on the card and read after the run
    rounds = profiling.counter("auction.rounds")
    with DeviceTimer(dev) as timer:
        sort_scan(cfg, st0, box, conf, valid, 1)
    rounds = profiling.counter("auction.rounds") - rounds
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sort_scan(cfg, st0, box, conf, valid, 1)
        torch.cuda.synchronize()
    # device-side entries only (the kernels); the aten ops that launch them
    # carry the same time again, and the device copies of `record_function`
    # ranges are no kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    ms = timer.seconds * 1e3 / steps
    print(f"{name}: {steps} frames, {ms:.4f} ms/frame (CUDA events), "
          f"{rounds / steps:.2f} auction rounds/frame, "
          f"device busy {busy_us / 1e3 / steps:.4f} ms/frame "
          f"(idle share {1 - busy_us / 1e3 / steps / ms:.3f} against the "
          f"CUDA-event time), {launches / steps:.1f} kernel launches/frame",
          flush=True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3 / steps:.4f} ms/frame "
              f"{e.count / steps:6.1f}/frame  {e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_sort: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    s = cs.oriented_stream(args.frames)
    ones = np.ones(s.shape[:2], np.float32)
    profile("oriented IoU D=500 T=2000",
            SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                       oriented=True),
            cs.OT, s, ones, ones > 0, dev)
    profile("Mahalanobis D=128 T=512",
            SortConfig(method="maha", assignment="auction", max_idle_epochs=5,
                       oriented=False, recycle_idle=True),
            cs.T, *maha_stream(args.frames, 2), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
