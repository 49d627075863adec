"""Benchmark harness of the port: the JAX package's `bench.py` matrix on
the card; prints ONE JSON line with the headline metric.

Run: python -m similari_tpu_torch.bench [--device cuda|cpu]

The configurations are `bench.py`'s, by name, width, seed and frame count
(`CONFIGS`): SORT at 10/100/500 objects (aligned and oriented, IoU and
Mahalanobis) on the general step, the fused SORT and VisualSORT kernels
(chunk 32), VisualSORT at 128-2048-d on the general step, NMS at 10-1000
boxes (the C++ host engine at 10), the batch sweeps of 64-4096 scenes and
the host engines' per-call rows.  Each `*_workload` builder puts a
configuration's inputs on the device and returns a `Workload`, whose
`run(n_frames)` steps a fresh state over the first frames and returns the
ids; `measure` times it.

Timing: CUDA events around a whole run of `base_len` frames from a fresh
state, the state built and the inputs uploaded before the first event;
one warm-up run on a prefix first (the kernels build, the allocator
settles).  A row is the median of `ROW_REPS` runs with the min-max
`_spread`; the headline sweep's points take `BENCH_POINT_REPS` (default
3).  Each device row also records `<name>_idle`, 1 - (kernel device time
/ window) from one `torch.profiler` run over its first `PROFILE_FRAMES`
frames, in a process of its own (`--profile NAME`), against the
CUDA-event window of an unprofiled run of the same frames (left out, with
a log line, when the profile's kernels on the device do not match its
launch calls on the host), and `<name>_peak_mib`,
`torch.cuda.max_memory_allocated` over the timed runs.  Host rows (NMS at
10 boxes, the interactive rows) take the host clock.

FLOP accounting: a static per-frame useful-work estimate (the
coefficients at `*_flops`); MFU is against the H100's dense bf16 peak, a
lower bound for the f32 and integer work these steps do.

Wall-clock guard: if the run passes BENCH_BUDGET seconds (default 2400)
the remaining configurations are SKIPPED WITH A LOG LINE.  BENCH_FAST=1
runs the smoke subset (`Config.fast`) with one run per row.

A configuration that raises records `<name>_error`; the line is still
printed and the script exits 1.  Nothing falls back to the CPU or to a
plain version: `--device cpu` is the caller's explicit choice (the plain
PyTorch versions), and without CUDA the script raises before it measures.

Diagnostics go to stderr; stdout carries exactly one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import native
from .bench_interactive import (REFERENCE_MS, REFS, batch_case, case_ms,
                                device_line, feature_case, log, sort_case,
                                visual_case)
from .device import resolve_device
from .eval.mot import DeviceTimer
from .ops.fused_sort import fused_sort_scan
from .ops.fused_visual import fused_visual_scan
from .ops.nms import nms_kernel
from .parallel.mesh import (batched_sort_step, batched_visual_step_chunked,
                            batched_visual_step_inplace, new_batched_state,
                            new_batched_visual_state)
from .trackers.sort_step import SortConfig, sort_scan
from .trackers.state import new_sort_state
from .trackers.visual_state import new_visual_state
from .trackers.visual_step import VisualConfig, visual_scan
from .utils import profiling

# Reference baselines (FPS): the Rust reference's published CPU numbers
# (BASELINE.md / the reference's benchmarks.md)
BASELINES = {
    "sort_iou_10": 9900.0,
    "sort_iou_100": 561.0,
    "sort_iou_500": 53.0,
    "sort_iou_oriented_100": 624.0,
    "sort_iou_oriented_500": 52.0,
    "sort_maha_100": 588.0,
    "sort_maha_oriented_100": 636.0,
    "batch_sort_iou_100": 618.0,
    "visual_sort_100x128": 262.0,
    "visual_sort_100x512": 173.0,
    "visual_sort_100x2048": 94.0,
    "nms_10": 632000.0,
    "nms_100": 6711.0,
    "nms_500": 250.0,
    "nms_1000": 72.0,
    "nms_oriented_10": 461000.0,
    "nms_oriented_100": 7100.0,
    "nms_oriented_300": 570.0,
    "nms_oriented_500": 218.0,
    "nms_oriented_1000": 54.0,
    "visual_sort_10x512": 2230.0,
    "visual_sort_50x512": 444.0,
    "visual_sort_100x256": 211.0,
    "visual_sort_100x1024": 133.0,
}

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s
FUSED_CHUNK = 32  # frames per launch of the fused kernels (bench.py's chunk)
GALLERY = 3  # gallery lanes of every VisualSORT row (bench.py's)
WARM_FRAMES = 32  # the warm-up run's prefix
PROFILE_FRAMES = 32  # the profiled prefix of the idle share
ROW_REPS = 3
# the host calls that launch one kernel each (runtime and driver API, and
# their Ex forms): a profile whose device shows another number of kernels
# than these calls is not whole (on the H100, profiles taken minutes into
# the full matrix missed kernels that a fresh process showed)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
NMS_THRESHOLD = 0.8
HOST_NMS_FRAMES = 4096  # bench.py::bench_nms_host's frames


# ---------------------------------------------------------------------------
# Static per-frame FLOP estimates (useful work, conservative), bench.py's:
# aligned IoU ~15 flops/pair; oriented clip ~700; Mahalanobis ~60; auction
# ~12 flops/cell/round x 3 rounds; state merge ~2*T*D MACs per column (~45
# columns); KF ~250 flops/det; gallery matmul 2*D*T*K*F; NMS fixpoint ~8
# rounds x 3 flops/cell.
# ---------------------------------------------------------------------------

def _pair_flops(method, oriented):
    if method == "maha":
        return 60.0
    return 700.0 if oriented else 15.0


def sort_step_flops(d, t, method, oriented):
    weights = d * t * _pair_flops(method, oriented)
    auction = 3 * d * t * 12.0
    kf = d * 250.0
    merge = 2 * t * d * 45.0
    return weights + auction + kf + merge


def visual_step_flops(d, t, k, f):
    gallery = 2.0 * d * t * k * f
    feat_merge = 2 * (2.0 * t * d * f)  # gallery lanes + history ring
    return gallery + feat_merge + sort_step_flops(d, t, "iou", False)


def nms_step_flops(n, oriented):
    return n * n * (_pair_flops("iou", oriented) + 8 * 3.0)


def box_stream(steps, n, seed=42, spread=1000.0):
    """Random-walk box stream akin to the reference BoxGen2
    (`examples.rs:188-249`); bench.py's arrays, bit for bit."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, size=(n, 2)).astype(np.float32)
    out = np.zeros((steps, n, 5), np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, size=xy.shape).astype(np.float32)
        wh += rng.uniform(-0.5, 0.5, size=wh.shape).astype(np.float32)
        out[s, :, 0] = xy[:, 0]
        out[s, :, 1] = xy[:, 1]
        out[s, :, 3] = wh[:, 0] / wh[:, 1]
        out[s, :, 4] = wh[:, 1]
    return out


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    """One configuration on its device.  `fresh()` builds a new state;
    `step(state, n)` runs the first `n` frames from it and returns the
    per-frame outputs (ids first), launching without a sync.  `inputs`
    holds the device-resident inputs by bench.py's names."""

    fresh: Callable[[], Any]
    step: Callable[[Any, int], tuple]
    flops: float  # per frame of one scene
    inputs: Dict[str, Any]
    scenes: int = 1
    granule: int = 1  # run lengths are multiples of this (the fused chunk)
    host: bool = False  # host work: host clock, no idle share or memory

    def run(self, n_frames: int) -> tuple:
        return self.step(self.fresh(), n_frames)


def _sort_config(method="iou", oriented=False):
    return SortConfig(method=method, assignment="auction", max_idle_epochs=5,
                      oriented=oriented)


def _visual_config(positional="iou"):
    return VisualConfig(
        positional_kind=positional, visual_kind="euclidean",
        visual_threshold=100.0, visual_minimal_track_length=3,
        max_idle_epochs=5, assignment="auction", oriented=False,
        feature_precision="bf16")


def _ones(shape, dev, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=dev)


def sort_scan_workload(method, n_objects, oriented, base_len, device=None):
    """bench.py::bench_sort_scan: the general SORT step over a random walk,
    capacity 4 x objects; oriented streams take angles in [0, 0.6)."""
    dev = resolve_device(device)
    cfg = _sort_config(method, oriented)
    s = box_stream(base_len, n_objects)
    if oriented:
        rng = np.random.default_rng(7)
        s[..., 2] = rng.uniform(0, 0.6, size=s.shape[:2])
    stream = torch.as_tensor(s, device=dev)
    conf = _ones((base_len, n_objects), dev)
    valid = _ones((base_len, n_objects), dev, torch.bool)

    def step(state, n):
        _, out = sort_scan(cfg, state, stream[:n], conf[:n], valid[:n], 1)
        return out.track_id, out.slot, out.overflow

    return Workload(
        lambda: new_sort_state(4 * n_objects, 1, device=dev), step,
        sort_step_flops(n_objects, 4 * n_objects, method, oriented),
        dict(stream=stream, conf=conf, valid=valid))


def sort_pallas_workload(n_objects, base_len, device=None, chunk=FUSED_CHUNK):
    """bench.py::bench_sort_pallas: the fused SORT kernel
    (`ops/fused_sort.py::fused_sort_scan`), same workload as sort_iou_<n>."""
    dev = resolve_device(device)
    cfg = _sort_config()
    stream = torch.as_tensor(box_stream(base_len, n_objects), device=dev)
    conf = _ones((base_len, n_objects), dev)
    valid = _ones((base_len, n_objects), dev, torch.bool)

    def step(state, n):
        _, (ids, slots, _pred, ovf) = fused_sort_scan(
            cfg, state, stream[:n], conf[:n], valid[:n], 1, chunk)
        return ids, slots, ovf

    return Workload(
        lambda: new_sort_state(4 * n_objects, 1, device=dev), step,
        sort_step_flops(n_objects, 4 * n_objects, "iou", False),
        dict(stream=stream, conf=conf, valid=valid), granule=chunk)


def batch_sort_workload(n_scenes, n_objects, base_len, device=None):
    """bench.py::bench_batch_sort_scan: S scenes stepped together by
    `parallel/mesh.py::batched_sort_step`, capacity 2 x objects."""
    dev = resolve_device(device)
    vstep = batched_sort_step(_sort_config())
    flat = box_stream(base_len, n_scenes * n_objects)
    stream = torch.as_tensor(
        flat.reshape(base_len, n_scenes, n_objects, 5), device=dev)
    conf = _ones((base_len, n_scenes, n_objects), dev)
    valid = _ones((base_len, n_scenes, n_objects), dev, torch.bool)
    epochs = torch.arange(1, base_len + 1, dtype=torch.int32, device=dev)[
        :, None].expand(base_len, n_scenes)

    def step(states, n):
        ids, ovf = [], []
        for i in range(n):
            states, out = vstep(states, stream[i], conf[i], valid[i],
                                epochs[i])
            ids.append(out.track_id)
            ovf.append(out.overflow)
        return torch.stack(ids), torch.stack(ovf)

    return Workload(
        lambda: new_batched_state(n_scenes, 2 * n_objects, 1, device=dev),
        step, sort_step_flops(n_objects, 2 * n_objects, "iou", False),
        dict(stream=stream, conf=conf, valid=valid), scenes=n_scenes)


def visual_scan_workload(n_objects, feat_dim, base_len, device=None):
    """bench.py::bench_visual_scan: single-scene VisualSORT on the general
    step (`trackers/visual_step.py::visual_scan`), bf16 gallery, one
    constant feature per detection re-fed every frame."""
    dev = resolve_device(device)
    cfg = _visual_config()
    rng = np.random.default_rng(0)
    stream = torch.as_tensor(box_stream(base_len, n_objects), device=dev)
    feat = torch.as_tensor(
        rng.normal(size=(n_objects, feat_dim)).astype(np.float32), device=dev)
    ones = _ones((n_objects,), dev)
    tru = _ones((n_objects,), dev, torch.bool)

    def step(state, n):
        o, t = ones.expand(n, -1), tru.expand(n, -1)
        _, out = visual_scan(cfg, state, stream[:n], o, t,
                             feat.expand(n, -1, -1), t, o, o, 1)
        return out.track_id, out.voting_type, out.overflow

    return Workload(
        lambda: new_visual_state(4 * n_objects, 1, GALLERY, feat_dim,
                                 feature_dtype=torch.bfloat16, device=dev),
        step, visual_step_flops(n_objects, 4 * n_objects, GALLERY, feat_dim),
        dict(stream=stream, feat=feat, ones=ones, tru=tru))


def visual_pallas_workload(n_objects, feat_dim, base_len, device=None,
                           chunk=FUSED_CHUNK, positional="iou"):
    """bench.py::bench_visual_pallas: the fused VisualSORT kernels
    (`ops/fused_visual.py::fused_visual_scan`: `gallery_dots`, then the
    frame loop per chunk), same workload as bench_visual_scan; positional
    "maha" gates by the Kalman state in the kernel."""
    dev = resolve_device(device)
    cfg = _visual_config(positional)
    rng = np.random.default_rng(0)
    stream = torch.as_tensor(box_stream(base_len, n_objects), device=dev)
    featsrc = rng.normal(size=(n_objects, feat_dim)).astype(np.float32)
    feats = torch.as_tensor(
        np.broadcast_to(featsrc, (base_len, n_objects, feat_dim)).copy(),
        device=dev)
    onesv = _ones((base_len, n_objects), dev)
    truv = _ones((base_len, n_objects), dev, torch.bool)

    def step(state, n):
        _, (ids, slots, _pred, vt, _new, _len, ovf) = fused_visual_scan(
            cfg, state, stream[:n], onesv[:n], truv[:n], feats[:n],
            truv[:n], onesv[:n], onesv[:n], 1, chunk)
        return ids, slots, vt, ovf

    return Workload(
        lambda: new_visual_state(4 * n_objects, 1, GALLERY, feat_dim,
                                 device=dev), step,
        visual_step_flops(n_objects, 4 * n_objects, GALLERY, feat_dim),
        dict(stream=stream, feats=feats, onesv=onesv, truv=truv),
        granule=chunk)


def batch_visual_workload(n_scenes, n_objects, feat_dim, base_len,
                          device=None, scene_chunk=0):
    """bench.py::bench_batch_visual_scan, the north-star configuration:
    S scenes of batched VisualSORT (`parallel/mesh.py::
    batched_visual_step_inplace`, the gallery writes by the merge kernel;
    scene_chunk > 0: `batched_visual_step_chunked`), bf16 gallery,
    capacity 2 x objects, one constant feature per detection."""
    dev = resolve_device(device)
    cfg = _visual_config()
    vstep = (batched_visual_step_chunked(cfg, scene_chunk) if scene_chunk
             else batched_visual_step_inplace(cfg))
    rng = np.random.default_rng(0)
    flat = box_stream(base_len, n_scenes * n_objects)
    boxes = torch.as_tensor(
        flat.reshape(base_len, n_scenes, n_objects, 5), device=dev)
    feat = torch.as_tensor(
        rng.normal(size=(n_scenes, n_objects, feat_dim)).astype(np.float32),
        device=dev)
    ones = _ones((n_scenes, n_objects), dev)
    tru = _ones((n_scenes, n_objects), dev, torch.bool)
    epochs = torch.arange(1, base_len + 1, dtype=torch.int32, device=dev)[
        :, None].expand(base_len, n_scenes)

    def step(states, n):
        ids = []
        for i in range(n):
            # the in-place step overwrites the states' gallery and history:
            # every run starts from its own fresh state
            states, out = vstep(states, boxes[i], ones, tru, feat, tru, ones,
                                ones, epochs[i])
            ids.append(out.track_id)
        return (torch.stack(ids),)

    return Workload(
        lambda: new_batched_visual_state(
            n_scenes, 2 * n_objects, 1, GALLERY, feat_dim,
            feature_dtype=torch.bfloat16, device=dev),
        step, visual_step_flops(n_objects, 2 * n_objects, GALLERY, feat_dim),
        dict(boxes=boxes, feat=feat, ones=ones, tru=tru), scenes=n_scenes)


def nms_workload(n_boxes, oriented, base_len, device=None):
    """bench.py::bench_nms: `ops/nms.py::nms_kernel` on independent frames
    after a descending sort of the ranks, threshold 0.8, the default route
    (the clip kernel's block-skip at n >= 512 oriented boxes on CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    b = box_stream(base_len, n_boxes, seed=5, spread=500.0)
    if oriented:
        b[..., 2] = rng.uniform(0, 0.6, size=b.shape[:2])
    boxes = torch.as_tensor(b, device=dev)
    ranks = torch.as_tensor(
        rng.uniform(0.5, 1.0, size=(base_len, n_boxes)).astype(np.float32),
        device=dev)
    valid = _ones((n_boxes,), dev, torch.bool)

    def step(_, n):
        keeps = []
        for i in range(n):
            order = torch.argsort(-ranks[i], stable=True)
            keeps.append(nms_kernel(boxes[i][order], valid, NMS_THRESHOLD,
                                    oriented))
        return (torch.stack(keeps),)

    return Workload(lambda: None, step, nms_step_flops(n_boxes, oriented),
                    dict(boxes=boxes, ranks=ranks, valid=valid))


def nms_host_workload(n_boxes, oriented, base_len=HOST_NMS_FRAMES,
                      device=None):
    """bench.py::bench_nms_host: the C++ host NMS (`native.nms_host_batch`),
    the engine below ~64 boxes, on `base_len` frames at once.  It runs on
    the host whatever `device` is."""
    rng = np.random.default_rng(3)
    b = np.zeros((base_len, n_boxes, 5), np.float32)
    spread = 60.0 * np.sqrt(n_boxes)
    b[..., 0] = rng.uniform(0, spread, (base_len, n_boxes))
    b[..., 1] = rng.uniform(0, spread, (base_len, n_boxes))
    if oriented:
        b[..., 2] = rng.uniform(0, 0.6, (base_len, n_boxes))
    b[..., 3] = 1.0
    b[..., 4] = rng.uniform(20, 50, (base_len, n_boxes))

    def step(_, n):
        return (native.nms_host_batch(b[:n], NMS_THRESHOLD, oriented),)

    return Workload(lambda: None, step, nms_step_flops(n_boxes, oriented),
                    dict(b=b), host=True)


def interactive_host_rows(reps=40):
    """bench.py::bench_interactive_host: per-call ms of the host engines
    (the C++ steps, engine="host") at the reference's widths, medians of
    `reps` warm calls on the host clock (the SORT and feature frames made
    inside the timed call, as there); the workloads are
    `bench_interactive`'s; references are the published per-call tables
    (api.md:250-257, benchmarks.md:82-86, 93-109, 116-120)."""
    cpu = torch.device("cpu")
    out = {}

    def row(key, case, n_reps=reps, frames_in_call=False):
        out[f"interactive_{key}_ms"] = round(
            case_ms(cpu, case, n_reps, frames_in_call), 3)

    for oriented in (False, True):
        for n in (10, 100, 500, 1000):
            row(f"sort{'_oriented' if oriented else ''}_{n}",
                sort_case(n, "host", cpu, oriented, draws_angles=True),
                frames_in_call=True)
    for n in (10, 100, 500):
        row(f"feature_{n}", feature_case(n),
            max(8, reps // (4 if n >= 500 else 1)), frames_in_call=True)
    for n in (10, 50, 100):
        row(f"visual_{n}", visual_case(n, "host", cpu))
    for n in (10, 100, 500):
        row(f"batch_sort_{n}", batch_case("iou", n, "host", cpu),
            max(8, reps // 2))
    return out


# published per-call ms of the interactive rows (bench.py:836-849)
INTERACTIVE_REFS = {
    **{f"sort_{n}": REFERENCE_MS[n] for n in (10, 100, 500, 1000)},
    **{f"{prefix}_{n}": ms for prefix, refs in REFS.items()
       for n, ms in refs.items()},
}


# ---------------------------------------------------------------------------
# Config matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Config:
    """One row of the matrix: `build(*args, base_len, device=, **kwargs)`
    returns its Workload.  `sweep` rows are the headline's batch VisualSORT
    points (BENCH_POINT_REPS runs each); `fast` rows form BENCH_FAST's
    subset."""

    name: str
    build: Callable[..., Workload]
    args: tuple
    base_len: int
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    unit: str = "FPS"
    fast: bool = False
    sweep: bool = False


@dataclasses.dataclass(frozen=True)
class RowsConfig:
    """Rows measured by `fn()` itself (ms per call), merged into the
    results as they come."""

    name: str
    fn: Callable[[], Dict[str, float]]
    fast = False  # never in BENCH_FAST's subset (bench.py's rule)


SCENES = "scene-frames/s"
CONFIGS = [
    # headline first: the batch VisualSORT saturation sweep
    *(Config(f"batch_visual_{s}x100x512", batch_visual_workload,
             (s, 100, 512), n, unit=SCENES, fast=s == 64, sweep=True)
      for s, n in ((64, 32), (256, 16), (1024, 8))),
    # batch SORT sweep
    *(Config(f"batch_sort_{s}x100", batch_sort_workload, (s, 100), n,
             unit=SCENES, fast=s == 64)
      for s, n in ((64, 64), (1024, 16), (4096, 8))),
    # single-scene SORT matrix (the general step)
    Config("sort_iou_100", sort_scan_workload, ("iou", 100, False), 2048,
           fast=True),
    Config("sort_maha_100", sort_scan_workload, ("maha", 100, False), 2048),
    Config("sort_iou_oriented_100", sort_scan_workload, ("iou", 100, True),
           1024),
    Config("sort_maha_oriented_100", sort_scan_workload,
           ("maha", 100, True), 1024),
    Config("sort_iou_500", sort_scan_workload, ("iou", 500, False), 512),
    Config("sort_iou_oriented_500", sort_scan_workload, ("iou", 500, True),
           512),
    Config("sort_iou_10", sort_scan_workload, ("iou", 10, False), 2048),
    # the fused kernels
    Config("sort_iou_100_pallas", sort_pallas_workload, (100,), 2048),
    Config("visual_sort_100x512_pallas", visual_pallas_workload, (100, 512),
           256),
    Config("visual_sort_100x512_pallas_maha", visual_pallas_workload,
           (100, 512), 256, kwargs=dict(positional="maha")),
    # single-scene VisualSORT objects x dims matrix (the general step)
    *(Config(f"visual_sort_{n}x{d}", visual_scan_workload, (n, d), frames)
      for n, d, frames in ((100, 128, 1024), (100, 256, 1024),
                           (100, 512, 1024), (100, 1024, 512),
                           (100, 2048, 512), (10, 512, 2048),
                           (50, 512, 1024))),
    # NMS: 10 boxes on the C++ host engine (bench.py's frames: 4096)
    Config("nms_10", nms_host_workload, (10, False), HOST_NMS_FRAMES,
           unit="frames/s"),
    *(Config(f"nms_{n}", nms_workload, (n, False), frames, unit="frames/s")
      for n, frames in ((100, 8192), (500, 2048), (1000, 1024))),
    Config("nms_oriented_10", nms_host_workload, (10, True), HOST_NMS_FRAMES,
           unit="frames/s"),
    *(Config(f"nms_oriented_{n}", nms_workload, (n, True), frames,
             unit="frames/s")
      for n, frames in ((100, 4096), (300, 1024), (500, 512), (1000, 256))),
    # interactive host-engine rows (no device work)
    RowsConfig("interactive_host", interactive_host_rows),
]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def _frames(w: Workload, n: int) -> int:
    """n cut down to a multiple of the workload's granule (at least one)."""
    return max(w.granule, n - n % w.granule)


def device_busy_ms(w: Workload, n: int) -> Optional[float]:
    """torch.profiler over one run of `n` frames from a fresh state: the
    device events' summed time in ms (kernels and copies), or None when
    the profile is not whole: no device event, or a count of kernels on
    the device that differs from the count of launch calls on the host."""
    state = w.fresh()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w.step(state, n)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = profiling.device_events(prof)
    kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                  for e in events)
    launches = sum(e.device_type != cuda and e.name.startswith(LAUNCH_CALLS)
                   for e in prof.events())
    if not events or kernels != launches:
        log(f"  idle share not measured: the profile shows {kernels} "
            f"kernels on the device, {launches} launch calls on the host")
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3


def measure(w: Workload, base_len: int, dev: torch.device, reps: int,
            over_budget: Callable[[], bool] = lambda: False) -> dict:
    """Rates of `reps` timed runs of `base_len` frames, each from a fresh
    state (scene-frames/s), after one warm-up run on a prefix; on the card
    also the peak memory of the timed runs.  `over_budget()` is asked
    between runs."""
    clock = torch.device("cpu") if w.host else dev
    on_card = clock.type == "cuda"
    w.run(_frames(w, min(base_len, WARM_FRAMES)))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    for rep in range(reps):
        if rep and over_budget():
            break
        state = w.fresh()
        if on_card:
            torch.cuda.synchronize()
        with DeviceTimer(clock) as timer:
            w.step(state, base_len)
        samples.append(w.scenes * base_len / timer.seconds)
    out = {"samples": samples}
    if on_card:
        out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    return out


def profiled_idle(w: Workload, base_len: int) -> Optional[float]:
    """The idle share of a warm workload on the card: 1 - the profiled
    busy time of its first PROFILE_FRAMES frames over the CUDA-event
    window of an unprofiled run of the same frames; None where the profile
    is not whole."""
    n = _frames(w, min(base_len, PROFILE_FRAMES))
    state = w.fresh()
    torch.cuda.synchronize()
    with DeviceTimer(torch.device("cuda")) as timer:
        w.step(state, n)
    busy = device_busy_ms(w, n)
    return None if busy is None else 1.0 - busy / (timer.seconds * 1e3)


def idle_share(name: str) -> Optional[float]:
    """Row `name`'s idle share, taken by `--profile name` in a process of
    its own: the profiles of one process lose more device records the more
    of them it takes (on the H100, 0 in a process's first profiles, then
    growing by about one kernel a profile), so each row's is its process's
    only profile.  Raises if that process fails."""
    proc = subprocess.run(
        [sys.executable, "-m", __spec__.name, "--profile", name],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True)
    for line in proc.stderr.splitlines():
        if line.startswith("  "):
            log(line)
    if proc.returncode != 0:
        raise RuntimeError(f"the profile of {name} exited {proc.returncode}:"
                           f" {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["idle"]


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card (default; raises without CUDA) or the "
                    "CPU's plain versions")
    ap.add_argument("--profile", metavar="NAME",
                    help="print only row NAME's idle share on the card, "
                    "{\"idle\": x or null}")
    args = ap.parse_args(argv)
    if args.profile:
        c = {c.name: c for c in CONFIGS}[args.profile]
        w = c.build(*c.args, c.base_len, device=resolve_device("cuda"),
                    **c.kwargs)
        w.run(_frames(w, min(c.base_len, WARM_FRAMES)))
        print(json.dumps({"idle": profiled_idle(w, c.base_len)}))
        return 0
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    results: Dict[str, Any] = {}
    mfus: Dict[str, float] = {}
    t_start = time.time()
    budget = float(os.environ.get("BENCH_BUDGET", "2400"))
    fast = os.environ.get("BENCH_FAST") == "1"
    point_reps = int(os.environ.get("BENCH_POINT_REPS", "1" if fast else "3"))
    row_reps = 1 if fast else ROW_REPS
    vbase = BASELINES["visual_sort_100x512"]
    best_visual: Optional[tuple] = None

    def over_budget(name):
        if time.time() - t_start > budget:
            log(f"SKIPPED (time budget {budget:.0f}s exceeded): {name}")
            return True
        return False

    def failed(name, e):
        log(f"{name} FAILED: {e!r}")
        traceback.print_exc(file=sys.stderr)
        results[name + "_error"] = repr(e)[:200]

    def record(c, m, flops):
        samples = sorted(m["samples"])
        fps = samples[len(samples) // 2]
        results[c.name + "_fps"] = round(fps, 2)
        if len(samples) > 1:
            results[c.name + "_spread"] = [round(samples[0], 2),
                                           round(samples[-1], 2)]
        mfu = fps * flops / PEAK_BF16
        mfus[c.name] = mfu
        base = BASELINES.get(c.name)
        vs = f" (reference {base:.0f}) [x{fps / base:.1f}]" if base else ""
        extra = ""
        if "idle" in m:
            results[c.name + "_idle"] = round(m["idle"], 4)
            extra += f", idle {m['idle']:.3f}"
        if "peak_mib" in m:
            results[c.name + "_peak_mib"] = round(m["peak_mib"], 1)
            extra += f", peak {m['peak_mib']:.1f} MiB allocated"
        log(f"{c.name}: {fps:.1f} {c.unit}{vs}  [{fps * flops / 1e9:.1f} "
            f"GFLOP/s, mfu {mfu:.4%}{extra}]")
        if len(samples) > 1:
            log(f"  median of {len(samples)} runs, spread "
                f"[{samples[0]:.1f}, {samples[-1]:.1f}]")
        if c.sweep:
            log(f"  -> x{fps / BASELINES['visual_sort_100x512']:.1f} vs "
                "reference single-stream")
        elif c.name.startswith("batch_sort"):
            log(f"  -> x{fps / BASELINES['batch_sort_iou_100']:.1f} vs "
                "reference single-stream")

    configs = [c for c in CONFIGS if c.fast or not fast]
    if fast:
        log(f"BENCH_FAST=1: {len(configs)} of {len(CONFIGS)} configurations, "
            f"{row_reps} run per row")
    for c in configs:
        if over_budget(c.name):
            continue
        if isinstance(c, RowsConfig):
            try:
                rows = c.fn()
            except Exception as e:  # recorded; the run goes on and exits 1
                failed(c.name, e)
                continue
            results.update(rows)
            for key, ref in INTERACTIVE_REFS.items():
                ms = rows.get(f"interactive_{key}_ms")
                if ms:
                    log(f"interactive_{key}: {ms:.3f} ms (reference "
                        f"{ref:.3f}) [x{ref / ms:.2f}]")
            continue
        try:
            w = c.build(*c.args, c.base_len, device=dev, **c.kwargs)
            flops = w.flops
            m = measure(w, c.base_len, dev,
                        point_reps if c.sweep else row_reps,
                        lambda: over_budget(c.name))
            if "peak_mib" in m:  # on the card
                w = None
                idle = idle_share(c.name)
                if idle is not None:
                    m["idle"] = idle
        except Exception as e:  # recorded; the run goes on and exits 1
            failed(c.name, e)
            continue
        finally:
            w = None  # free the inputs before the next row
        record(c, m, flops)
        if c.sweep and (best_visual is None or results[c.name + "_fps"]
                        > best_visual[0]):
            best_visual = (results[c.name + "_fps"], c.args[0])

    log(f"total bench time: {time.time() - t_start:.1f}s")
    headline, knee = best_visual or (None, None)
    print(json.dumps({
        "metric": "batch_visual_sort_scene_fps",
        "value": headline,
        "unit": (f"scene-frames/sec at saturation knee ({knee} scenes x "
                 "100 objects x 512-d, gallery 3)"),
        "vs_baseline": None if headline is None else round(headline / vbase,
                                                           3),
        "device": card,
        "extra": {
            **results,
            "knee_scenes": knee,
            **{f"mfu_{k}": float(f"{v:.4g}") for k, v in mfus.items()
               if k.startswith("batch_visual") or k.startswith("visual")},
        },
    }))
    return 1 if any(k.endswith("_error") for k in results) else 0


if __name__ == "__main__":
    sys.exit(main())
