"""MOTChallenge-format IO and sequence runners (mirrors
`similari_tpu/eval/mot.py`).

`read_detections`, `read_gt` and `write_csv` read and write the MOT csv
format.  `run_sequence_interactive` and `run_sequence_interactive_visual`
run a sequence frame by frame through a tracker's `predict_arrays`, with
whichever engine the tracker passed in was built with.

`run_sequence_device` and `run_sequence_device_visual` pad a sequence into
SoA buffers (`run_sequence_device` reads a MOT det csv path with the
port's C++ loader, `native.py::load_sequence_soa`, as the JAX package's
does), expand frame gaps into all-invalid frames (the fused kernels
run consecutive epochs), and run the whole sequence through the fused SORT
or VisualSORT kernel: on the card by default, or through the kernels'
plain PyTorch versions when `device="cpu"`.  Both also run the general
step (`engine="step"`: per-frame epochs, every method and assignment, and
for VisualSORT own-area gates computed on the device).  Own-area shares
from the f64 clipping oracle (`own_area_backend="host"`) feed either
engine.
"""

from __future__ import annotations

import csv
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device
from ..trackers.sort_step import SortConfig
from ..trackers.visual_step import VisualConfig
from ..utils.pad import pad_pow2 as _pad_pow2

Detections = Dict[int, List[Tuple[float, float, float, float, float]]]
Outputs = Dict[int, List[Tuple[int, float, float, float, float]]]

CHUNK = 16  # frames per kernel launch


def read_detections(file_path) -> Detections:
    """MOT csv rows: frame, id, left, top, width, height, conf, x, y, z."""
    frame_detections: Detections = {}
    with open(file_path, "r") as f:
        for row in csv.reader(f):
            frame = int(row[0])
            frame_detections.setdefault(frame, []).append(
                tuple(map(float, row[2:7]))
            )
    return frame_detections


def read_gt(file_path) -> Outputs:
    """MOT gt csv rows -> {frame: [(track id, left, top, width, height)]}."""
    out: Dict[int, List] = {}
    with open(file_path, "r") as f:
        for row in csv.reader(f):
            frame = int(row[0])
            tid = int(row[1])
            l, t, w, h = map(float, row[2:6])
            out.setdefault(frame, []).append((tid, l, t, w, h))
    return out


def write_csv(file_path, rows):
    with open(file_path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def frame_rows(rows) -> np.ndarray:
    """One frame's detections as float32 [N, >=5] rows; an empty frame
    (`[]`, or any array of no rows) is [0, 5]: a frame with no
    detection."""
    dets = np.asarray(rows, np.float32)
    return dets.reshape(0, 5) if dets.size == 0 else dets


def ltwh_to_vec5(dets: np.ndarray) -> np.ndarray:
    """[N, >=4] LTWH (col 4, when present, = confidence) -> [N,5]
    (xc, yc, angle, aspect, height).  Only an exactly-6-column input
    carries an angle (column 5)."""
    out = np.zeros((len(dets), 5), np.float32)
    out[:, 0] = dets[:, 0] + dets[:, 2] / 2.0
    out[:, 1] = dets[:, 1] + dets[:, 3] / 2.0
    if dets.shape[1] == 6:
        out[:, 2] = dets[:, 5]
    out[:, 3] = dets[:, 2] / np.maximum(dets[:, 3], 1e-6)
    out[:, 4] = dets[:, 3]
    return out


def vec5_to_ltwh(v: np.ndarray) -> np.ndarray:
    out = np.zeros((len(v), 4), np.float32)
    w = v[:, 3] * v[:, 4]
    out[:, 0] = v[:, 0] - w / 2.0
    out[:, 1] = v[:, 1] - v[:, 4] / 2.0
    out[:, 2] = w
    out[:, 3] = v[:, 4]
    return out


def run_sequence_interactive(tracker, detections: Detections) -> Outputs:
    """Frame by frame through `tracker.predict_arrays` (a `Sort`, on
    either engine), reporting the predicted box per track id.  Frame-number
    gaps advance the epoch clock (`skip_epochs_for_scene`), so idle aging
    matches a run that steps every frame."""
    out: Dict[int, List] = {}
    prev = None
    for frame in sorted(detections):
        if prev is not None and frame - prev > 1:
            tracker.skip_epochs_for_scene(0, int(frame - prev - 1))
        prev = frame
        dets = frame_rows(detections[frame])
        boxes = ltwh_to_vec5(dets)
        confs = np.clip(dets[:, 4], 0.0, 1.0).astype(np.float32)
        _, ids, pred, _, _ = tracker.predict_arrays(0, boxes, confs)
        ltwh = vec5_to_ltwh(pred)
        out[frame] = [
            (int(ids[i]), *map(float, ltwh[i])) for i in range(len(ids))
        ]
    return out


def run_sequence_interactive_visual(
    tracker, detections: Detections, features: Dict[int, List],
    qualities: Optional[Dict[int, List[float]]] = None,
) -> Outputs:
    """Frame by frame through `VisualSort.predict_arrays` (either engine).
    `features[frame][i]` aligns with `detections[frame][i]` (None = no
    ReID); reports the observed box per track id, as
    `run_sequence_device_visual`'s `report_observed=True` default does."""
    out: Dict[int, List] = {}
    prev = None
    for frame in sorted(detections):
        if prev is not None and frame - prev > 1:
            tracker.skip_epochs_for_scene(0, int(frame - prev - 1))
        prev = frame
        dets = frame_rows(detections[frame])
        fdim = max((len(x) for x in features.get(frame, []) if x is not None),
                   default=1)
        boxes, confs, _, feat, fvalid, qual = (x[0] for x in _buffers(
            {frame: dets}, len(dets), features, fdim, qualities))
        _, ids, _pred, _, _, _ = tracker.predict_arrays(
            0, boxes, confs, feat, fvalid, qual)
        ltwh = dets[:, :4]
        out[frame] = [
            (int(ids[i]), *map(float, ltwh[i])) for i in range(len(ids))
        ]
    return out


def _expand_gaps(frames, arrays):
    """Expand a frame-compressed stream to the dense frame range by inserting
    all-invalid rows for missing frames.  Returns (dense index of each
    frame[S], expanded arrays)."""
    f = np.asarray(frames, np.int64)
    span = int(f[-1] - f[0] + 1)
    if span == len(f):
        return np.arange(len(f)), arrays
    if span > 8 * len(f) + 4096:
        raise ValueError(
            f"frame range {span} is far sparser than the {len(f)} detection "
            "frames; the fused kernels need consecutive epochs")
    pos = (f - f[0]).astype(np.int64)
    out = []
    for a in arrays:
        e = np.zeros((span,) + a.shape[1:], a.dtype)
        e[pos] = a
        out.append(e)
    return pos, out


def _assemble_outputs(frames, valid, box, pred, ids, report_observed) -> Outputs:
    out: Outputs = {}
    for s, f in enumerate(frames):
        n = int(valid[s].sum())
        src = box[s, :n] if report_observed else pred[s, :n]
        ltwh = vec5_to_ltwh(src)
        out[f] = [(int(ids[s, i]), *map(float, ltwh[i])) for i in range(n)]
    return out


def _check_overflow(overflow, capacity: int) -> None:
    """Raise if any frame overflowed the static track capacity."""
    flags = np.asarray(overflow)
    if flags.any():
        first = int(np.argmax(flags))
        raise RuntimeError(
            f"track store overflow at frame index {first}: more live tracks "
            f"than capacity={capacity}; re-run with a larger capacity"
        )


def _epochs_of(frames) -> np.ndarray:
    """Per-frame epochs from the frame numbers (first frame = epoch 1), so
    gaps age tracks as stepping every frame would."""
    f = np.asarray(frames, np.int64)
    return (f - f[0] + 1).astype(np.int32)


def _chunked(frames, arrays):
    """Gap-expand, then pad with all-invalid frames to a multiple of the
    chunk (CHUNK frames, or the whole span when shorter).  Returns (dense
    index of each frame, span, chunk, arrays)."""
    pos, arrays = _expand_gaps(frames, arrays)
    span = len(arrays[0])
    chunk = min(CHUNK, span) if span % CHUNK else CHUNK
    pad = (-span) % chunk
    if pad:
        arrays = [np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
            for a in arrays]
    return pos, span, chunk, arrays


class DeviceTimer:
    """Device time of a region, in `seconds`: CUDA events on the card, the
    host clock (after the work returns) on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def __enter__(self):
        if self.dev.type == "cuda":
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.ev[1].record()
            self.ev[1].synchronize()
            self.seconds = self.ev[0].elapsed_time(self.ev[1]) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0
        return False


def _auction_only(assignment: str) -> None:
    if assignment != "auction":
        raise ValueError(
            f"assignment={assignment!r}: the fused kernels assign with their "
            "in-kernel auction only")


def sequence_sort_config(
    iou_threshold: float = 0.3,
    max_idle_epochs: int = 5,
    recycle_idle: bool = True,
) -> SortConfig:
    """The SortConfig `run_sequence_device` runs (same defaults)."""
    return SortConfig(
        method="iou", iou_threshold=iou_threshold,
        max_idle_epochs=max_idle_epochs, assignment="auction",
        oriented=False, recycle_idle=recycle_idle,
    )


def sequence_visual_config(
    visual_kind: str = "cosine",
    visual_threshold: float = 0.5,
    minimal_track_length: int = 1,
    iou_threshold: float = 0.3,
    max_idle_epochs: int = 10,
    feature_precision: str = "bf16",
    **cfg_overrides,
) -> VisualConfig:
    """The VisualConfig `run_sequence_device_visual` runs (same defaults);
    keyword args beyond these override `VisualConfig` fields."""
    cfg = VisualConfig(
        positional_kind="iou", iou_threshold=iou_threshold,
        visual_kind=visual_kind, visual_threshold=visual_threshold,
        visual_minimal_track_length=minimal_track_length,
        max_idle_epochs=max_idle_epochs, assignment="auction",
        oriented=False, feature_precision=feature_precision,
        recycle_idle=True,
    )
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides else cfg


def _buffers(detections: Detections, dpad: int, features=None, fdim=1,
             qualities=None):
    """The padded SoA buffers of a detections dict, frames ascending: box
    [S, dpad, 5], conf [S, dpad] clipped to [0, 1], valid [S, dpad], feat
    [S, dpad, fdim] and fvalid [S, dpad] from `features` (none without),
    qual [S, dpad] from `qualities` (default 1.0).  An empty frame holds
    no valid row."""
    frames = sorted(detections)
    steps = len(frames)
    box = np.zeros((steps, dpad, 5), np.float32)
    conf = np.zeros((steps, dpad), np.float32)
    valid = np.zeros((steps, dpad), bool)
    feat = np.zeros((steps, dpad, fdim), np.float32)
    fvalid = np.zeros((steps, dpad), bool)
    qual = np.ones((steps, dpad), np.float32)
    for s, f in enumerate(frames):
        dets = frame_rows(detections[f])
        n = len(dets)
        box[s, :n] = ltwh_to_vec5(dets)
        conf[s, :n] = np.clip(dets[:, 4], 0.0, 1.0)
        valid[s, :n] = True
        for i, fv in enumerate((features or {}).get(f, [])[:n]):
            if fv is not None:
                feat[s, i, : len(fv)] = fv
                fvalid[s, i] = True
        if qualities is not None:
            q = qualities.get(f, [])[:n]
            qual[s, : len(q)] = q
    return box, conf, valid, feat, fvalid, qual


def run_sequence_device(
    detections: Detections,
    method: str = "iou",
    iou_threshold: float = 0.3,
    max_idle_epochs: int = 5,
    capacity: int = 512,
    report_observed: bool = False,
    assignment: str = "auction",
    recycle_idle: bool = True,
    device: DeviceLike = None,
    engine: str = "fused",
) -> Tuple[Outputs, float]:
    """Whole-sequence SORT on the device.

    `detections` may also be a path to a MOT det csv: the C++ loader
    (`native.py::load_sequence_soa`) reads it into the padded buffers
    (6-column files with confidence 1.0, header lines skipped), the
    confidences clipped to [0, 1].  engine="fused" (the
    default here) runs the fused SORT kernel over 16-frame chunks: aligned
    IoU matching (`method="iou"`) with its in-kernel auction
    (`assignment="auction"`) only.  engine="step" runs the general step
    (`trackers/sort_step.py::sort_scan`) frame by frame with per-frame
    epochs: IoU or Mahalanobis (`method="maha"`), assignment "auction",
    "hungarian", "native" or "auto".  The JAX package's default is its
    general step (`engine="xla"`); both engines give the same ids.  The
    fused engine raises ValueError, before any launch and on every device,
    for more than 1024 detections in a frame (`ops/fused_sort.py::
    check_sort_shape`).  Returns (per-frame outputs, frames/s of the timed
    run: CUDA-event time on the card).
    """
    from ..trackers.state import new_sort_state

    if engine not in ("fused", "step"):
        raise ValueError(f"unknown engine {engine!r}: 'fused' or 'step'")
    if engine == "fused":
        if method != "iou":
            raise NotImplementedError(
                "the fused SORT kernel matches by aligned IoU; Mahalanobis "
                "matching runs on engine='step'")
        _auction_only(assignment)
    dev = resolve_device(device)
    if isinstance(detections, (str, Path)):
        frames_arr, box, conf, valid = native.load_sequence_soa(detections)
        frames = frames_arr.tolist()
        conf = np.clip(conf, 0.0, 1.0) * valid
    else:
        frames = sorted(detections)
        dpad = _pad_pow2(max((len(detections[f]) for f in frames),
                             default=1))
        box, conf, valid = _buffers(detections, dpad)[:3]
    steps = len(frames)
    if steps == 0:
        return {}, 0.0
    if engine == "fused":
        from ..ops.fused_sort import check_sort_shape

        check_sort_shape(box.shape[1], capacity)

    cfg = sequence_sort_config(iou_threshold, max_idle_epochs, recycle_idle)
    state = new_sort_state(capacity, 1, device=dev)
    if engine == "step":
        from ..trackers.sort_step import sort_scan

        cfg = dataclasses.replace(cfg, method=method, assignment=assignment)
        args = [torch.as_tensor(a, device=dev) for a in (box, conf, valid)]
        with DeviceTimer(dev) as timer:
            state, outs = sort_scan(cfg, state, *args, _epochs_of(frames))
        fps = steps / timer.seconds
        _check_overflow(outs.overflow.cpu().numpy(), capacity)
        ids = outs.track_id.cpu().numpy()
        pred = outs.pred_box.cpu().numpy()
        return (_assemble_outputs(frames, valid, box, pred, ids,
                                  report_observed), fps)

    from ..ops.fused_sort import fused_sort_scan

    pos, span, chunk, (box2, conf2, valid2) = _chunked(
        frames, (box, conf, valid))
    args = [torch.as_tensor(a, device=dev) for a in (box2, conf2, valid2)]
    with DeviceTimer(dev) as timer:
        state, (kids, _slots, kpred, kovf) = fused_sort_scan(
            cfg, state, *args, 1, chunk)
    fps = steps / timer.seconds
    _check_overflow(kovf.cpu().numpy()[:span], capacity)
    ids = kids.cpu().numpy()[pos]
    pred = kpred.cpu().numpy()[pos]
    return _assemble_outputs(frames, valid, box, pred, ids, report_observed), fps


def run_sequence_device_visual(
    detections: Detections,
    features: Dict[int, List],
    visual_kind: str = "cosine",
    visual_threshold: float = 0.5,
    minimal_track_length: int = 1,
    iou_threshold: float = 0.3,
    max_idle_epochs: int = 10,
    capacity: int = 512,
    gallery: int = 3,
    report_observed: bool = True,
    assignment: str = "auction",
    feature_precision: str = "bf16",
    qualities: Optional[Dict[int, List[float]]] = None,
    device: DeviceLike = None,
    engine: str = "fused",
    **cfg_overrides,
) -> Tuple[Outputs, float]:
    """Whole-sequence VisualSORT on the device.

    `features[frame][i]` aligns with `detections[frame][i]`; None entries
    fall back to positional voting for that detection.  `qualities`
    optionally carries per-detection feature quality (default 1.0).
    Remaining keyword args override `VisualConfig` fields.
    engine="fused" (the default here) runs the fused kernel over 16-frame
    chunks with its in-kernel auction (`assignment="auction"`); it takes
    own-area gates only as precomputed shares, and raises ValueError
    before any launch, on every device, for more than 1024 detections in
    a frame or a state past the kernel's shared memory
    (`ops/fused_visual.py::check_visual_shape`: 51,200 slots at 128 rows
    and 3 lanes).  engine="step" runs the general step
    (`trackers/visual_step.py::visual_scan`) frame by frame with per-frame
    epochs, any assignment, and own-area gates with shares computed on the
    device (`own_area_backend="device"`); the JAX package's `engine="xla"`.
    With `own_area_backend="host"` the shares of every frame come from the
    f64 clipping oracle (`utils/clipping.py`), for either engine, as the
    JAX runner does.  Returns (per-frame outputs, frames/s of the timed
    run: CUDA-event time on the card).
    """
    from ..trackers.visual_state import new_visual_state

    if engine not in ("fused", "step"):
        raise ValueError(f"unknown engine {engine!r}: 'fused' or 'step'")
    cfg = dataclasses.replace(
        sequence_visual_config(
            visual_kind, visual_threshold, minimal_track_length,
            iou_threshold, max_idle_epochs, feature_precision,
            **cfg_overrides),
        assignment=assignment)
    if engine == "fused":
        if cfg.own_area_on_device:
            raise ValueError(
                "the fused kernel takes own-area gates only as precomputed "
                "shares: pass own_area_backend='host', or run "
                "engine='step', which computes the shares on the device")
        _auction_only(assignment)
    dev = resolve_device(device)
    frames = sorted(detections)
    steps = len(frames)
    if steps == 0:
        return {}, 0.0
    fdim = max(
        (len(x) for f in frames for x in features.get(f, []) if x is not None),
        default=1,
    )
    dpad = _pad_pow2(max(len(detections[f]) for f in frames))
    if engine == "fused":
        from ..ops.fused_visual import check_visual_shape

        check_visual_shape(dpad, capacity, gallery)
    box, conf, valid, feat, fvalid, qual = _buffers(
        detections, dpad, features, fdim, qualities)
    oa = np.ones((steps, dpad), np.float32)
    gates = cfg.own_area_use > 0.0 or cfg.own_area_collect > 0.0
    if gates and cfg.own_area_backend == "host":
        from ..trackers.visual import own_area_shares_host

        for s in range(steps):
            n = int(valid[s].sum())
            oa[s, :n] = own_area_shares_host(box[s, :n], conf[s, :n])

    state = new_visual_state(capacity, 1, gallery, fdim, device=dev)
    if engine == "step":
        from ..trackers.visual_step import visual_scan

        args = [torch.as_tensor(a, device=dev)
                for a in (box, conf, valid, feat, fvalid, qual, oa)]
        with DeviceTimer(dev) as timer:
            state, outs = visual_scan(cfg, state, *args, _epochs_of(frames))
        fps = steps / timer.seconds
        _check_overflow(outs.overflow.cpu().numpy(), capacity)
        ids = outs.track_id.cpu().numpy()
        pred = outs.pred_box.cpu().numpy()
        return (_assemble_outputs(frames, valid, box, pred, ids,
                                  report_observed), fps)

    from ..ops.fused_visual import fused_visual_scan

    pos, span, chunk, arrays = _chunked(
        frames, (box, conf, valid, feat, fvalid, qual, oa))
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    with DeviceTimer(dev) as timer:
        state, (kids, _slots, kpred, _vt, _new, _len, ovf) = fused_visual_scan(
            cfg, state, *args, 1, chunk)
    fps = steps / timer.seconds
    _check_overflow(ovf.cpu().numpy()[:span], capacity)
    ids = kids.cpu().numpy()[pos]
    pred = kpred.cpu().numpy()[pos]
    return _assemble_outputs(frames, valid, box, pred, ids,
                             report_observed), fps
