#!/usr/bin/env python3
"""Time the fused SORT path of one checkout on one NVIDIA GPU.

For the main path's config (`sequence_sort_config()`, D=128 rows for 100
objects, T=512, the runners' chunk of 16 frames) on the two streams of
`chip_smoke.py` phase 3 (random walk, crowded) it prints the CUDA-event
ms per `fused_sort_chunk` call (three runs) and, where the checkout's
kernel takes phase stamps, the frame's ms in each phase and the cluster
barriers per frame from one more run; then the fused VisualSORT chunk's
ms on its main-path config (three runs, the kernel that shares the
header), the frames/s of `run_sequence_device` on phase 4's 1024-frame
sequence (two runs), and the SORT kernel's device ms per launch on that
path from `torch.profiler` (its first 256 frames).  One JSON line holds
the numbers.

`--root DIR` imports `chip_smoke.py` and the package from another
checkout, for example a parent commit unpacked with `git archive`, so
two versions can be timed in turns in one call on one card:

    for r in _archive/parent . . _archive/parent; do
        python3 tools/profile_fused_sort.py --root $r; done

Usage: python3 tools/profile_fused_sort.py [--root DIR] [--frames N]
                                           [--seed S]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def split(fs, cs, cfg, st0, inputs):
    """(ms per frame in each phase, frame ms, cluster barriers per frame
    or None) from one profiled run of the stream."""
    n = len(fs.PHASES) + 1
    width = getattr(fs, "PROF_WIDTH", n)
    stamps = []

    def profiled(cfg, st, *xs):
        prof = torch.zeros((cs.CHUNK, width), dtype=torch.int64,
                           device=xs[0].device)
        stamps.append(prof)
        return fs.fused_sort_chunk(cfg, st, *xs, prof=prof)

    cs.run_chunks(profiled, cfg, st0, inputs)
    st = torch.cat(stamps).cpu().numpy()
    per_phase = (np.diff(st[:, :n], axis=1).mean(0) / 1e6).tolist()
    barriers = float(st[:, n].mean()) if width > n else None
    return per_phase, float((st[:, n - 1] - st[:, 0]).mean() / 1e6), barriers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fused_sort: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]
    import chip_smoke as cs
    from similari_tpu_torch.eval.mot import (run_sequence_device,
                                             sequence_sort_config,
                                             sequence_visual_config)
    from similari_tpu_torch.ops import fused_sort as fs
    from similari_tpu_torch.ops import fused_visual as fv
    from similari_tpu_torch.trackers.state import new_sort_state
    from similari_tpu_torch.trackers.visual_state import new_visual_state

    dev = torch.device("cuda")
    cfg = sequence_sort_config()
    st0 = fs.state_to_tuple(new_sort_state(cs.T, 1, device=dev))
    streams = {
        "random_walk": cs.make_inputs(args.frames, args.seed)[:3],
        "crowded": cs.crowded_stream(args.seed, args.frames, cs.D,
                                     cs.D_VALID, cs.F, cs.CROWD_SPREAD)[:3],
    }
    out = {"root": str(root), "gpu": cs.gpu_line()}
    for name, arrays in streams.items():
        inputs = [torch.as_tensor(x, device=dev) for x in arrays]
        cs.run_chunks(fs.fused_sort_chunk, cfg, st0, inputs)  # warm-up
        runs, rounds = [], None
        for _ in range(3):
            _, outs, ms = cs.run_chunks(fs.fused_sort_chunk, cfg, st0, inputs)
            runs.append(ms)
            rounds = float(outs[-1][:, 0].float().mean())
        entry = dict(chunk_ms=runs, rounds_per_frame=rounds,
                     plan=getattr(fs.fused_sort_chunk, "plan", None))
        cs.log(f"fused_sort[{name}]: {', '.join(f'{x:.4f}' for x in runs)} ms "
               f"per {cs.CHUNK}-frame launch, {rounds:.2f} auction rounds per "
               f"frame; launch {entry['plan']}")
        if hasattr(fs, "PHASES"):
            per_phase, frame, barriers = split(fs, cs, cfg, st0, inputs)
            entry.update(frame_ms=frame, barriers_per_frame=barriers,
                         phases=dict(zip(fs.PHASES, per_phase)))
            cs.log(f"fused_sort[{name}] phase split (ms/frame): " + ", ".join(
                f"{n} {x:.4f}" for n, x in zip(fs.PHASES, per_phase))
                + f"; frame {frame:.4f}" + ("" if barriers is None else
                                            f"; cluster barriers/frame "
                                            f"{barriers:.2f}"))
        out[name] = entry
    vcfg = sequence_visual_config()
    vst0 = fv.state_to_tuple(new_visual_state(cs.T, 1, cs.K, cs.F, device=dev))
    vin = [torch.as_tensor(x, device=dev)
           for x in cs.make_inputs(args.frames, args.seed + 1)]
    cs.run_chunks(fv.fused_visual_chunk, vcfg, vst0, vin)
    out["visual_chunk_ms"] = [
        cs.run_chunks(fv.fused_visual_chunk, vcfg, vst0, vin)[2]
        for _ in range(3)]
    cs.log(f"fused_visual[main_path, random_walk]: "
           f"{', '.join(f'{x:.4f}' for x in out['visual_chunk_ms'])} ms per "
           f"{cs.CHUNK}-frame chunk")
    dets, _ = cs.synthetic_sequence(1024, args.seed + 2)
    fps = [run_sequence_device(dets, capacity=cs.T)[1] for _ in range(2)]
    out["main_path_frames_per_s"] = fps
    sub = {f: dets[f] for f in sorted(dets)[:256]}
    _, _, kernels = cs.device_profile(
        lambda: run_sequence_device(sub, capacity=cs.T), len(sub))
    times = [e.time_range.elapsed_us() / 1e3 for e in kernels
             if "fused_sort_kernel" in e.name]
    out["main_path_kernel_ms"] = float(np.mean(times))
    cs.log(f"main path: run_sequence_device "
           f"{', '.join(f'{x:.1f}' for x in fps)} frames/s (1024 frames x "
           f"{cs.D_VALID} objects, CUDA events); fused_sort_kernel "
           f"{out['main_path_kernel_ms']:.5f} ms per launch on the path "
           f"(torch.profiler, {len(times)} launches)")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
