#!/usr/bin/env python3
"""Time the fused VisualSORT path of one checkout on one NVIDIA GPU.

For the main path's config (`sequence_visual_config()`, D=128 rows for 100
objects, T=512, K=3, F=512, the runners' chunk of 16 frames) on the two
streams of `chip_smoke.py` phase 3 (random walk, crowded) it prints the
CUDA-event ms per `fused_visual_chunk` call and, from one more run with
the kernel's phase stamps, the scan's ms per frame in each phase; then
the frames/s of `run_sequence_device_visual` on phase 4's 1024-frame
sequence (two runs).  One JSON line holds the numbers.

`--root DIR` imports `chip_smoke.py` and the package from another
checkout, for example a parent commit unpacked with `git archive`, so
two versions can be timed in turns in one call on one card:

    for r in _archive/parent . . _archive/parent; do
        python3 tools/profile_fused_visual.py --root $r; done

Usage: python3 tools/profile_fused_visual.py [--root DIR] [--frames N]
                                             [--seed S]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fused_visual: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]
    import chip_smoke as cs
    from similari_tpu_torch.eval.mot import (CHUNK, run_sequence_device_visual,
                                             sequence_visual_config)
    from similari_tpu_torch.ops import fused_visual as fv
    from similari_tpu_torch.trackers.visual_state import new_visual_state

    dev = torch.device("cuda")
    cfg = sequence_visual_config()
    st0 = fv.state_to_tuple(new_visual_state(cs.T, 1, cs.K, cs.F, device=dev))
    streams = {
        "random_walk": cs.make_inputs(args.frames, args.seed + 1),
        "crowded": cs.crowded_stream(args.seed + 1, args.frames, cs.D,
                                     cs.D_VALID, cs.F, cs.CROWD_SPREAD),
    }
    out = {"root": str(root), "gpu": cs.gpu_line()}
    for name, arrays in streams.items():
        inputs = [torch.as_tensor(x, device=dev) for x in arrays]
        fv.fused_visual_chunk(cfg, st0, *(x[:CHUNK] for x in inputs), 1)
        runs = [cs.run_chunks(fv.fused_visual_chunk, cfg, st0, inputs)[2]
                for _ in range(3)]
        per_phase, frame, _ = cs.phase_split(fv, fv.fused_visual_chunk, cfg,
                                             st0, inputs)
        out[name] = dict(chunk_ms=runs, frame_ms=frame,
                         phases=dict(zip(fv.PHASES, per_phase.tolist())))
        cs.log(f"{name}: {', '.join(f'{x:.4f}' for x in runs)} ms per "
               f"{CHUNK}-frame chunk")
        cs.log_split(f"fused_visual[main_path, {name}]", fv.PHASES,
                     (per_phase, frame, None))
    dets, feats = cs.synthetic_sequence(1024, args.seed + 2)
    fps = [run_sequence_device_visual(dets, feats, capacity=cs.T,
                                      gallery=cs.K)[1] for _ in range(2)]
    out["main_path_frames_per_s"] = fps
    cs.log(f"main path: run_sequence_device_visual "
           f"{', '.join(f'{x:.1f}' for x in fps)} frames/s (1024 frames x "
           f"{cs.D_VALID} objects, CUDA events)")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
