"""The port's host C++ runtime on numpy arrays (mirrors the JAX package's
`native` module, its `__init__.py`).

The library (`csrc/`: `lap.cpp`, `motloader.cpp`, `sortstep.cpp`,
`nms.cpp`, `visualstep.cpp` with `kf.h` and `clip.h`) builds on first use
with the system C++ compiler (`_build.py::host_library`).  Where it cannot
build, every entry point here raises RuntimeError with the compiler's
output: nothing returns None and nothing routes around the library.

* `lap_max` / `lap_max_batch`: the exact LAP solver (`ops/lap.py`).
* `sort_step_host` / `SortStepSession`: a whole SORT epoch on a state of
  numpy leaves, in place (`trackers/host_sort.py`, `trackers/sort.py`).
* `visual_step_host` / `VisualStepSession`: a whole VisualSORT epoch
  (`trackers/host_visual.py`, `trackers/visual.py`), its gallery product
  taken by BLAS above `_DMAT_MIN_MADDS` multiply-adds (`_visual_dmat`) and
  by the step's own dot loop below, as in the JAX package: the two round
  differently, so the split sits at the same place.
* `kf_box_sequence` / `kf_point_sequence`: the Kalman API's
  `filter_sequence` (`utils/kalman.py`).
* `rotated_iou_pairs`, `nms_host`, `nms_host_batch`: the f32 rotated IoU
  of the host steps, and greedy NMS for small frames (`utils/nms.py`).
* `load_sequence_soa`: a MOT det/gt csv as padded buffers
  (`eval/mot.py::run_sequence_device`); `_load_sequence_soa_numpy` is its
  plain version, for the tests.

A session holds raw pointers to the state's numpy leaves: its owner drops
it wherever those arrays are replaced (grow, the oriented flip, a
checkpoint load).  Every leaf handed to C must be a C-contiguous numpy
array of the step's dtype; anything else raises ValueError.
"""

from __future__ import annotations

import csv
import ctypes

import numpy as np

from . import _build

OVERFLOW = 1  # the steps' return code for a full track store


def _ptr(a: np.ndarray, dtype, shape) -> int:
    """The address of a state leaf handed to C: a C-contiguous numpy array
    of `dtype` (bool for uint8) and `shape`, else ValueError."""
    ok = (isinstance(a, np.ndarray) and a.flags.c_contiguous
          and a.shape == shape
          and (a.dtype == dtype
               or (dtype == np.uint8 and a.dtype == np.bool_)))
    if not ok:
        raise ValueError(
            f"a leaf handed to the native step must be a C-contiguous numpy "
            f"array of {np.dtype(dtype).name} and shape {shape}, got "
            f"{a!r:.60}")
    return a.ctypes.data


def _f32(a, shape=None) -> np.ndarray:
    """`a` as a C-contiguous f32 array, of `shape` if given (ValueError
    otherwise)."""
    a = np.ascontiguousarray(a, np.float32)
    if shape is not None and a.shape != shape:
        raise ValueError(f"expected shape {shape}, got {a.shape}")
    return a


def _check(rc: int, what: str, capacity: int) -> None:
    if rc == OVERFLOW:
        raise RuntimeError(f"track store overflow (capacity {capacity})")
    if rc:
        raise RuntimeError(f"{what} failed: {rc}")


def _constraints(cfg) -> np.ndarray:
    """(delta, max distance) pairs, ascending delta, flattened."""
    return (np.ascontiguousarray(
        np.asarray(sorted(cfg.constraints), np.float32).reshape(-1))
        if cfg.constraints else np.zeros((0,), np.float32))


# --------------------------------------------------------------------------
# LAP
# --------------------------------------------------------------------------

def lap_max(weights: np.ndarray) -> np.ndarray:
    """Exact maximisation LAP: weights [R, C] (R <= C) -> column per row
    [R] int32."""
    lib = _build.host_library()
    w = _f32(weights)
    r, c = w.shape
    out = np.zeros((r,), np.int32)
    err = lib.lap_solve_max(w.ctypes.data, r, c, out.ctypes.data)
    if err:
        raise RuntimeError(f"lap_solve_max failed: {err}")
    return out


def lap_max_batch(weights: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Batched exact LAP: weights [B, R, C] -> columns [B, R] int32, the
    problems spread over `n_threads` threads (0: one per core)."""
    lib = _build.host_library()
    w = _f32(weights)
    b, r, c = w.shape
    out = np.zeros((b, r), np.int32)
    err = lib.lap_solve_batch_max(w.ctypes.data, b, r, c, out.ctypes.data,
                                  n_threads)
    if err:
        raise RuntimeError(f"lap_solve_batch_max failed: {err}")
    return out


# --------------------------------------------------------------------------
# SORT step
# --------------------------------------------------------------------------

def _sort_state_ptrs(state):
    """The 15 state pointers of `sort_step_host`, in its order."""
    kf, t, h = state.kf, state.capacity, state.history
    f, i, u = np.float32, np.int32, np.uint8
    return (*(_ptr(a, f, (t, 5)) for a in (
                kf.mean_pos, kf.mean_vel, kf.cpp, kf.cpv, kf.cvv,
                state.pred_box, state.obs_box)),
            _ptr(state.conf, f, (t,)), _ptr(state.active, u, (t,)),
            _ptr(state.last_epoch, i, (t,)), _ptr(state.length, i, (t,)),
            _ptr(state.track_id, i, (t,)),
            _ptr(state.hist_obs, f, (t, h, 5)),
            _ptr(state.hist_pred, f, (t, h, 5)),
            _ptr(state.hist_conf, f, (t, h)))


def _sort_cfg_args(cfg, cons: np.ndarray):
    return (0 if cfg.method == "iou" else 1, 1 if cfg.oriented else 0,
            cfg.iou_threshold, cfg.min_confidence, cfg.max_idle_epochs,
            cfg.position_weight, cfg.velocity_weight,
            cfg.new_track_threshold, cons.ctypes.data, len(cfg.constraints))


def _sort_outputs(d: int):
    """slot, track id, is_new, pred box, length, next id."""
    return (np.empty((d,), np.int32), np.empty((d,), np.int32),
            np.empty((d,), np.uint8), np.empty((d, 5), np.float32),
            np.empty((d,), np.int32), np.empty((1,), np.int32))


def sort_step_host(cfg, state, det_box, det_conf, epoch: int):
    """One SORT epoch in one native call (`csrc/sortstep.cpp`) on a state
    of numpy leaves, mutated in place.  Returns (next_id, slot, track_id,
    is_new, pred_box, length); raises RuntimeError on a store overflow
    (callers grow first)."""
    return SortStepSession(cfg, state).step(det_box, det_conf, epoch,
                                            int(state.next_id))


class SortStepSession:
    """The native SORT step of one store with its arguments prebuilt: the
    config and the 15 state pointers never change between calls (the
    leaves are written in place), so a call passes only the detections,
    the id counter and the output buffers.  Rebuild it when the state's
    arrays are replaced or the config changes."""

    __slots__ = ("_lib", "_pre", "_keep", "state", "cfg")

    def __init__(self, cfg, state):
        self._lib = _build.host_library()
        cons = _constraints(cfg)
        self._keep = cons  # ctypes holds a raw pointer to it
        self._pre = (*_sort_cfg_args(cfg, cons), *_sort_state_ptrs(state),
                     state.capacity, state.history)
        self.state = state  # keeps the leaves alive
        self.cfg = cfg

    def step(self, det_box, det_conf, epoch: int, next_id: int):
        """(next_id, slot, track_id, is_new, pred_box, length), arrays the
        caller owns."""
        d = len(det_box)
        det_box, det_conf = _f32(det_box, (d, 5)), _f32(det_conf, (d,))
        outs = _sort_outputs(d)
        rc = self._lib.sort_step_host(
            *self._pre, int(next_id), det_box.ctypes.data,
            det_conf.ctypes.data, d, int(epoch),
            *(o.ctypes.data for o in outs))
        _check(rc, "sort_step_host", self.state.capacity)
        slot, tid, new, pred, length, nid = outs
        return int(nid[0]), slot, tid, new.astype(bool), pred, length


# --------------------------------------------------------------------------
# Kalman sequences, rotated IoU, NMS
# --------------------------------------------------------------------------

def kf_box_sequence(z: np.ndarray, position_weight: float,
                    velocity_weight: float) -> np.ndarray:
    """Box-Kalman smoothing of one track: z [N, 5] vec5 observations ->
    filtered means [N, 5] (initiate from row 0, then predict and update
    per row, the `benches/kalman_bbox.rs` loop in one call)."""
    z = _f32(z)
    if z.ndim != 2 or z.shape[1] != 5:
        raise ValueError(f"boxes must be [N, 5], got shape {z.shape}")
    lib = _build.host_library()
    out = np.empty_like(z)
    rc = lib.kf_box_sequence(z.ctypes.data, z.shape[0],
                             float(position_weight), float(velocity_weight),
                             out.ctypes.data)
    if rc:
        raise RuntimeError(f"kf_box_sequence failed: {rc}")
    return out


def kf_point_sequence(z: np.ndarray, position_weight: float,
                      velocity_weight: float) -> np.ndarray:
    """Point-Kalman smoothing: z [N, 2] (one chain) or [N, P, 2] (P
    independent keypoint chains) -> filtered means of the same shape (the
    `benches/kalman_2d_point.rs` loop in one call).  The last dimension
    must be 2: the loop reads and writes two floats per chain."""
    z = _f32(z)
    if z.ndim < 2 or z.shape[-1] != 2:
        raise ValueError(f"points must be [N, ..., 2], got shape {z.shape}")
    lib = _build.host_library()
    p = int(np.prod(z.shape[1:-1], dtype=np.int64))
    out = np.empty_like(z)
    rc = lib.kf_point_sequence(z.ctypes.data, z.shape[0], p,
                               float(position_weight), float(velocity_weight),
                               out.ctypes.data)
    if rc:
        raise RuntimeError(f"kf_point_sequence failed: {rc}")
    return out


def rotated_iou_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotated IoU of a[i] against b[i], box rows [n, 5]: the f32 clip of
    the host steps (`csrc/clip.h`), exposed for tests."""
    a, b = _f32(a), _f32(b)
    if a.shape != b.shape or a.ndim != 2 or a.shape[1] != 5:
        raise ValueError(f"a and b must be [n, 5] alike, got {a.shape} and "
                         f"{b.shape}")
    lib = _build.host_library()
    out = np.empty((a.shape[0],), np.float32)
    rc = lib.rotated_iou_pairs(a.ctypes.data, b.ctypes.data, a.shape[0],
                               out.ctypes.data)
    if rc:
        raise RuntimeError(f"rotated_iou_pairs failed: {rc}")
    return out


def nms_host(boxes: np.ndarray, threshold: float,
             oriented: bool) -> np.ndarray:
    """Greedy NMS on boxes [n, 5] sorted by descending rank -> keep [n]
    bool (`csrc/nms.cpp`, the reference's semantics)."""
    b = _f32(boxes, (len(boxes), 5))
    lib = _build.host_library()
    keep = np.empty((len(b),), np.uint8)
    rc = lib.nms_host(b.ctypes.data, len(b), float(threshold),
                      int(bool(oriented)), keep.ctypes.data)
    if rc:
        raise RuntimeError(f"nms_host failed: {rc}")
    return keep.astype(bool)


def nms_host_batch(boxes: np.ndarray, threshold: float,
                   oriented: bool) -> np.ndarray:
    """`nms_host` over frames: boxes [B, n, 5] -> keep [B, n] bool."""
    w = _f32(boxes)
    if w.ndim != 3 or w.shape[2] != 5:
        raise ValueError(f"boxes must be [B, n, 5], got shape {w.shape}")
    lib = _build.host_library()
    bb, n, _ = w.shape
    keep = np.empty((bb, n), np.uint8)
    rc = lib.nms_host_batch(w.ctypes.data, bb, n, float(threshold),
                            int(bool(oriented)), keep.ctypes.data)
    if rc:
        raise RuntimeError(f"nms_host_batch failed: {rc}")
    return keep.astype(bool)


# --------------------------------------------------------------------------
# VisualSORT step
# --------------------------------------------------------------------------

# below this many multiply-adds the step's own dot loop beats gathering the
# columns for one BLAS sgemm: the JAX package's split, kept so the two
# packages round the gallery distances alike
_DMAT_MIN_MADDS = 2_000_000


def _visual_dmat(max_idle_epochs, state, det_feat, epoch):
    """The gallery products of the compatible tracks as one BLAS sgemm:
    (dmat [D, C*K] f32, C), or (None, -1) below `_DMAT_MIN_MADDS`.  The
    columns follow `visualstep.cpp`'s rule (active and epoch - last_epoch
    <= max idle, in slot order); the step checks C against its own."""
    mask = (state.active != 0) & (
        (np.int32(epoch) - state.last_epoch) <= max_idle_epochs)
    ncols = int(mask.sum())
    k = state.gallery_size
    if det_feat.shape[0] * ncols * k * state.feature_dim < _DMAT_MIN_MADDS:
        return None, -1
    flat = state.feats[mask].reshape(ncols * k, state.feature_dim)
    return det_feat @ flat.T, ncols


def _visual_cfg_arrays(cfg):
    fcfg = np.asarray([
        cfg.iou_threshold, cfg.positional_min_confidence,
        cfg.visual_threshold, cfg.visual_minimal_area,
        cfg.visual_minimal_quality_use, cfg.visual_minimal_quality_collect,
        cfg.own_area_use, cfg.own_area_collect,
        cfg.position_weight, cfg.velocity_weight, cfg.new_track_threshold,
    ], np.float32)
    icfg = np.asarray([
        0 if cfg.positional_kind == "iou" else 1,
        0 if cfg.visual_kind == "euclidean" else 1,
        cfg.visual_min_votes, cfg.visual_minimal_track_length,
        cfg.max_idle_epochs, len(cfg.constraints),
        1 if cfg.oriented else 0,
    ], np.int32)
    return fcfg, icfg, _constraints(cfg)


def _visual_state_ptrs(state):
    """The 22 state pointers of `visual_step_host`, in its order."""
    kf, t, h = state.kf, state.capacity, state.history
    k, nf = state.gallery_size, state.feature_dim
    f, i, u = np.float32, np.int32, np.uint8
    return (*(_ptr(a, f, (t, 5)) for a in (
                kf.mean_pos, kf.mean_vel, kf.cpp, kf.cpv, kf.cvv,
                state.pred_box, state.obs_box)),
            _ptr(state.conf, f, (t,)),
            _ptr(state.active, u, (t,)), _ptr(state.last_epoch, i, (t,)),
            _ptr(state.length, i, (t,)), _ptr(state.track_id, i, (t,)),
            _ptr(state.feats, f, (t, k, nf)),
            _ptr(state.feat_quality, f, (t, k)),
            _ptr(state.feat_valid, u, (t, k)),
            _ptr(state.collected, i, (t,)), _ptr(state.voting_type, i, (t,)),
            _ptr(state.hist_obs, f, (t, h, 5)),
            _ptr(state.hist_pred, f, (t, h, 5)),
            _ptr(state.hist_conf, f, (t, h)),
            _ptr(state.hist_feat, f, (t, h, nf)),
            _ptr(state.hist_feat_valid, u, (t, h)))


def _visual_dets(feature_dim, det_box, det_conf, det_feat, det_feat_valid,
                 det_quality, det_own_area):
    d = len(det_box)
    fv = np.ascontiguousarray(det_feat_valid, np.uint8)
    if fv.shape != (d,):
        raise ValueError(f"expected shape {(d,)}, got {fv.shape}")
    return (_f32(det_box, (d, 5)), _f32(det_conf, (d,)),
            _f32(det_feat, (d, feature_dim)), fv, _f32(det_quality, (d,)),
            _f32(det_own_area, (d,)))


def _visual_outputs(d: int):
    """slot, track id, is_new, pred box, length, voting type, next id."""
    return (np.empty((d,), np.int32), np.empty((d,), np.int32),
            np.empty((d,), np.uint8), np.empty((d, 5), np.float32),
            np.empty((d,), np.int32), np.empty((d,), np.int32),
            np.empty((1,), np.int32))


class VisualStepSession:
    """The native VisualSORT step of one store with its arguments
    prebuilt, as `SortStepSession`.  f32 galleries only."""

    __slots__ = ("_lib", "_pre", "_keep", "state", "cfg")

    def __init__(self, cfg, state):
        self._lib = _build.host_library()
        if state.feats.dtype != np.float32:
            raise ValueError("the native VisualSORT step takes an f32 "
                             f"gallery, got {state.feats.dtype}")
        arrays = _visual_cfg_arrays(cfg)
        self._keep = arrays  # ctypes holds raw pointers to them
        self._pre = (*(a.ctypes.data for a in arrays),
                     *_visual_state_ptrs(state), state.capacity,
                     state.history, state.gallery_size, state.feature_dim)
        self.state = state  # keeps the leaves alive
        self.cfg = cfg

    def step(self, det_box, det_conf, det_feat, det_feat_valid, det_quality,
             det_own_area, epoch: int, next_id: int):
        """(next_id, slot, track_id, is_new, pred_box, length,
        voting_type), arrays the caller owns."""
        dets = _visual_dets(self.state.feature_dim, det_box, det_conf,
                            det_feat, det_feat_valid, det_quality,
                            det_own_area)
        d = dets[0].shape[0]
        dmat, dmat_cols = _visual_dmat(self.cfg.max_idle_epochs, self.state,
                                       dets[2], epoch)
        outs = _visual_outputs(d)
        rc = self._lib.visual_step_host(
            *self._pre, int(next_id), *(a.ctypes.data for a in dets),
            None if dmat is None else dmat.ctypes.data, dmat_cols, d,
            int(epoch), *(o.ctypes.data for o in outs))
        _check(rc, "visual_step_host", self.state.capacity)
        slot, tid, new, pred, length, vt, nid = outs
        return int(nid[0]), slot, tid, new.astype(bool), pred, length, vt


def visual_step_host(cfg, state, det_box, det_conf, det_feat, det_feat_valid,
                     det_quality, det_own_area, epoch: int):
    """One VisualSORT epoch in one native call (`csrc/visualstep.cpp`) on
    a state of numpy leaves with an f32 gallery, mutated in place.
    Returns (next_id, slot, track_id, is_new, pred_box, length,
    voting_type); raises RuntimeError on a store overflow."""
    return VisualStepSession(cfg, state).step(
        det_box, det_conf, det_feat, det_feat_valid, det_quality,
        det_own_area, epoch, int(state.next_id))


# --------------------------------------------------------------------------
# MOT csv loader
# --------------------------------------------------------------------------

def load_sequence_soa(path):
    """A MOTChallenge det/gt csv as padded buffers, in one C++ pass over
    the file (`csrc/motloader.cpp`): rows `frame, id, left, top, width,
    height[, conf[, ...]]`, a missing confidence read as 1.0, lines that
    do not parse (a header) skipped.  Returns (frames [F] int32 ascending,
    box [F, dpad, 5] vec5 f32, conf [F, dpad] f32 as written, valid
    [F, dpad] bool), dpad the power of two from 8 that holds the fullest
    frame."""
    lib = _build.host_library()
    handle = lib.mot_load(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        dims = (ctypes.c_int64 * 3)()
        lib.mot_dims(handle, dims)
        nf, dpad = int(dims[0]), int(dims[1])
        frames = np.zeros((nf,), np.int32)
        box = np.zeros((nf, dpad, 5), np.float32)
        conf = np.zeros((nf, dpad), np.float32)
        valid = np.zeros((nf, dpad), np.uint8)
        if nf:
            lib.mot_frames(handle, frames.ctypes.data)
            lib.mot_fill(handle, box.ctypes.data, conf.ctypes.data,
                         valid.ctypes.data)
    finally:
        lib.mot_free(handle)
    return frames, box, conf, valid.astype(bool)


def _load_sequence_soa_numpy(path):
    """The plain version of `load_sequence_soa`: the same rows, grouping,
    padding and f32 arithmetic, in Python."""
    parsed = []
    with open(path, "r") as fh:
        for r in csv.reader(fh):
            if len(r) < 6:
                continue
            try:
                vals = [np.float32(x) for x in r[:6]]
            except ValueError:
                continue  # a header or garbage line
            try:
                conf = np.float32(r[6])
            except (IndexError, ValueError):
                conf = np.float32(1.0)  # no confidence column
            parsed.append((int(vals[0]), *vals[2:6], conf))
    counts = {}
    for row in parsed:
        counts[row[0]] = counts.get(row[0], 0) + 1
    frames = sorted(counts)
    dpad = 8
    while dpad < max(counts.values(), default=1):
        dpad *= 2
    nf = len(frames)
    box = np.zeros((nf, dpad, 5), np.float32)
    conf = np.zeros((nf, dpad), np.float32)
    valid = np.zeros((nf, dpad), bool)
    index = {f: i for i, f in enumerate(frames)}
    cursor = [0] * nf
    half = np.float32(0.5)
    for f, l, t, w, h, c in parsed:
        s = index[f]
        i = cursor[s]
        cursor[s] += 1
        box[s, i] = (l + w * half, t + h * half, 0.0,
                     w / max(h, np.float32(1e-6)), h)
        conf[s, i] = c
        valid[s, i] = True
    return np.asarray(frames, np.int32), box, conf, valid
