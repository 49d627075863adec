#!/usr/bin/env python3
"""Device time of the gallery product and the rotated-box clip kernel on one
NVIDIA GPU, beside the CUDA-event time of a wrapper call.

For `gallery_dots` at the main path's launch shape (`chip_smoke.py`
phase 3: N = 16 x 128 chunk rows, M = 512 x 3 lanes, F = 512), in bf16
(the main path) and f32, it prints:

- the CUDA-event ms per call of a loop of wrapper calls (host work, the
  output allocations and the ctypes call included);
- the device ms per call by `torch.profiler` over a loop of calls: the
  mean time of each kernel whose name holds "gallery_dots", summed;
- the same two for the one PyTorch call of the same function:
  `torch.mm(x_bf16, cols_bf16.T, out_dtype=torch.float32)` in bf16,
  `x @ cols.T` in f32 with TF32 off;
- the device ms per launch on the VisualSORT main path (the first 256
  frames of `run_sequence_device_visual` under the profiler).

For `clip_pairs` on `chip_smoke.py` phase 5's three inputs (IoU of the
x-sorted D=500 / T=2000 oriented SORT frame, the same boxes unsorted, the
intersection at n=1000 on the NMS stream) it prints the CUDA-event ms per
wrapper call and the profiler's device ms per launch of every kernel whose
name holds "clip_pairs".

`--root DIR` imports `chip_smoke.py` and the package from another
checkout (a parent commit unpacked with `git archive`), so two versions
can be timed in turns in one call on one card:

    for r in _archive/parent . . _archive/parent; do
        python3 tools/profile_dots_clip.py --root $r; done

Usage: python3 tools/profile_dots_clip.py [--root DIR] [--calls N]
                                          [--seed S]
One JSON line at the end holds the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def device_ms(fn, match, calls):
    """torch.profiler over `calls` calls of fn (after one warm-up call):
    device ms per call of the kernels whose name holds `match` (the mean
    time of each such kernel, summed over the kernels: each runs once a
    call; the profiler may drop some launches), and {kernel name: (launches
    seen, mean ms)}."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    times = {}
    for e in prof.events():
        # the device copies of `record_function` ranges are no kernels
        if (e.device_type == cuda and match in e.name
                and not getattr(e, "is_user_annotation", False)):
            times.setdefault(e.name, []).append(e.time_range.elapsed_us())
    means = {name: sum(t) / len(t) / 1e3 for name, t in times.items()}
    return (sum(means.values()),
            {name: (len(times[name]), ms) for name, ms in means.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_dots_clip: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]
    import chip_smoke as cs
    from similari_tpu_torch.eval.mot import CHUNK, run_sequence_device_visual
    from similari_tpu_torch.ops import clip as cl
    from similari_tpu_torch.ops import gallery_dots as gd

    dev = torch.device("cuda")
    n_calls = args.calls
    out = {"root": str(root), "gpu": cs.gpu_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    cs.log(f"{out['gpu']}; root {root}; torch {out['torch']} cuda "
           f"{out['cuda']}")

    feat = torch.as_tensor(cs.make_inputs(2 * CHUNK, args.seed + 1)[3],
                           device=dev)
    x = feat[:CHUNK].reshape(CHUNK * cs.D, cs.F)
    g = feat[CHUNK:2 * CHUNK].reshape(-1, cs.F)[:cs.T * cs.K].contiguous()
    cols = torch.cat([g, x])
    xb, cb = x.bfloat16(), cols.bfloat16()
    libs = {True: (lambda: torch.mm(xb, cb.T, out_dtype=torch.float32),
                   "torch.mm(x_bf16, cols_bf16.T, out_dtype=torch.float32)"),
            False: (lambda: gd.f32_dots(x, cols),
                    "x @ cols.T in f32, TF32 off")}
    dots = {}
    for bf16 in (True, False):
        label = "bf16" if bf16 else "f32"
        call = lambda: gd.gallery_dots(x, g, bf16, cs.D)  # noqa: E731
        lib, name = libs[bf16]
        ev = cs.time_ms(dev, call, n_calls)
        dv, names = device_ms(call, "gallery_dots", n_calls)
        lib_ev = cs.time_ms(dev, lib, n_calls)
        lib_dv, lib_names = device_ms(lib, "", n_calls)
        dots[label] = dict(event_ms=ev, device_ms=dv, kernels=names,
                           library=name, library_event_ms=lib_ev,
                           library_device_ms=lib_dv,
                           library_kernels=lib_names)
        cs.log(f"gallery_dots[{label}] N={x.shape[0]} M={g.shape[0]} "
               f"F={cs.F}: wrapper call {ev:.5f} ms (CUDA events), device "
               f"{dv:.5f} ms per call {names}; library {name}: {lib_ev:.5f} "
               f"ms (events), device {lib_dv:.5f} ms {lib_names}")
    out["gallery_dots"] = dots

    dets, feats = cs.synthetic_sequence(256, args.seed + 2)
    dv, names = device_ms(lambda: run_sequence_device_visual(
        dets, feats, capacity=cs.T, gallery=cs.K), "gallery_dots", 1)
    out["gallery_dots"]["main_path_device_ms"] = dv
    cs.log(f"gallery_dots on the main path (256 frames, {256 // CHUNK} "
           f"launches): device {dv:.5f} ms per launch {names}")

    stream = torch.as_tensor(cs.oriented_stream(2, args.seed + 42),
                             device=dev)
    pred = torch.zeros((cs.OT, 5), dtype=torch.float32, device=dev)
    pred[:cs.OD] = stream[0]
    active = torch.arange(cs.OT, device=dev) < cs.OD
    det_s = cs.x_sorted(stream[1], torch.ones(cs.OD, dtype=torch.bool,
                                              device=dev))
    trk_s = cs.x_sorted(pred, active)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    det_u = det_s[torch.randperm(cs.OD, generator=gen).to(dev)]
    trk_u = trk_s[torch.randperm(cs.OT, generator=gen).to(dev)]
    nms = torch.as_tensor(cs.nms_stream(1)[0], device=dev)
    nms_s = cs.x_sorted(nms, torch.ones(cs.NMS_N, dtype=torch.bool,
                                        device=dev))
    cases = {"sorted": (det_s, trk_s, True), "unsorted": (det_u, trk_u, True),
             "nms": (nms_s, nms_s, False)}
    clips = {}
    for name, (a, b, want_iou) in cases.items():
        a8, b8 = cl.clip_columns(a), cl.clip_columns(b)
        call = lambda: cl.clip_pairs(a8, b8, want_iou)  # noqa: E731
        ev = cs.time_ms(dev, call, n_calls)
        dv, names = device_ms(call, "clip_pairs", n_calls)
        far = cl.far_pairs(a8, b8)
        tiles = int(cl.tiles_to_run(far))
        bound = cs.clip_bound_ms(far.shape[0], far.shape[1],
                                 int((~far).sum()))
        clips[name] = dict(event_ms=ev, device_ms=dv, kernels=names,
                           tiles_run=tiles, bound_ms=bound[0])
        cs.log(f"clip[{name}] D={far.shape[0]} T={far.shape[1]}: wrapper "
               f"call {ev:.5f} ms (CUDA events), device {dv:.5f} ms per "
               f"launch {names}; {tiles} tiles run; bound {bound[0]:.6f} ms")
    out["clip_pairs"] = clips
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
