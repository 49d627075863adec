"""Host SORT step: the interactive engine for per-call use
(mirrors `similari_tpu/trackers/host_sort.py`).

A per-call predict on the device pays a fixed cost of launches, copies and
synchronisation; at one frame of tens to hundreds of detections that cost
dwarfs the math.  This module runs the same step semantics as
`sort_step.sort_step` (the same formulas, the same f32 op order, the same
assignment LP) on a `SortState` whose leaves are numpy arrays:

* distance weights as `sort_step`'s (`sort/metric.rs:38-77`, the
  compatible gate of `sort.rs:250-270`);
* voting solves the same augmented LP (`sort/voting.rs:27-100`) exactly
  with the port's C++ solver (`ops/lap.py`), shrunk first by the dominance
  reduction (a column whose best weight is below the new-track threshold
  is never used by an optimum: every row owns a private threshold
  diagonal) and then split into bipartite connected components;
* the Kalman update is the block recurrence of `ops/kalman.py`.

`host_sort_step` runs the whole epoch in one call of the port's C++ step
(`native.py::sort_step_host`, `csrc/sortstep.cpp`), as the JAX module
does when its library builds; its states are the JAX native step's bit
for bit.  `host_sort_step_numpy` is the NumPy step above, op for op the
JAX module's NumPy path: the plain twin the tests hold the native step
against (ids equal, states within rounding).

`state_to_host` / `state_to_device` / `host_grow` move a state between
numpy leaves and torch tensors; `as_tensors` views numpy leaves as CPU
tensors that share their memory, for the trackers' waste and idle paths.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..ops.kalman import CHI2INV95, CHI2_UPPER_BOUND
from ..ops.lap import lap_max
from .sort_step import SortConfig
from .state import SortState, map_tensors

_CHI2_GATE = np.float32(CHI2INV95[4])  # 11.070, `kalman_2d_box.rs:174` (0-based [4])


# ---------------------------------------------------------------------------
# NumPy Kalman blocks (identical op order to ops/kalman.py; all f32)
# ---------------------------------------------------------------------------

def _stds(k, cnst, p, weight):
    """[w*k*p, w*k*p, w*k*p, cnst, w*k*p] per `kalman_2d_box.rs:46-54`."""
    s = np.float32(k * weight) * p
    out = np.stack([s, s, s, np.full_like(s, np.float32(cnst)), s], axis=-1)
    return out


def _kf_initiate(cfg: SortConfig, z: np.ndarray):
    p = z[..., 4]
    sp = _stds(2.0, 1e-2, p, cfg.position_weight)
    sv = _stds(10.0, 1e-5, p, cfg.velocity_weight)
    zero = np.zeros_like(z)
    return z.copy(), zero, sp * sp, zero.copy(), sv * sv


def _kf_predict(cfg, mp, mv, cpp, cpv, cvv):
    p = mp[..., 4]
    qp = _stds(1.0, 1e-2, p, cfg.position_weight) ** 2
    qv = _stds(1.0, 1e-5, p, cfg.velocity_weight) ** 2
    return (
        mp + mv,
        mv,
        cpp + np.float32(2.0) * cpv + cvv + qp,
        cpv + cvv,
        cvv + qv,
    )


def _kf_update(cfg, mp, mv, cpp, cpv, cvv, z):
    r = _stds(1.0, 1e-1, mp[..., 4], cfg.position_weight) ** 2
    S = cpp + r
    nu = z - mp
    gp = cpp / S
    gv = cpv / S
    return (
        mp + nu * gp,
        mv + nu * gv,
        cpp - cpp * gp,
        cpv - cpp * gv,
        cvv - cpv * gv,
    )


# ---------------------------------------------------------------------------
# Distance weights (mirrors sort_step.distance_weights)
# ---------------------------------------------------------------------------

def _host_weights(cfg: SortConfig, state: SortState, det_box, det_conf,
                  epoch: int, cols: np.ndarray) -> np.ndarray:
    """[D, C] voting weights against the compatible track columns `cols`."""
    conf = np.maximum(det_conf, np.float32(cfg.min_confidence))
    pred = state.pred_box[cols]  # [C, 5]

    if cfg.constraints:
        delta = np.int32(epoch) - state.last_epoch[cols]
        allowed = np.full(delta.shape, np.inf, np.float32)
        for dd, max_dist in sorted(cfg.constraints, reverse=True):
            allowed = np.where(delta <= dd, np.float32(max_dist), allowed)
        # dist_in_2r (`bbox.rs:464-474`)
        rd = _radius(det_box)[:, None] + _radius(pred)[None, :]
        cd2 = _center_dist2(det_box, pred)
        d2r = np.sqrt(cd2) / np.sqrt(rd * rd + np.float32(1e-5))
        compat = d2r <= allowed[None, :]
    else:
        compat = True

    if cfg.method == "iou" and cfg.oriented:
        # rotated IoU via the f32 boundary-integral clip (host_geometry is a
        # literal transliteration of ops/geometry.py for id-exact parity)
        from .host_geometry import rotated_iou_matrix_np

        iou, valid = rotated_iou_matrix_np(det_box, pred)
        m = iou * conf[:, None]
        valid &= m >= np.float32(cfg.iou_threshold)
        return np.where(valid & compat, m, np.float32(0.0))

    if cfg.method == "iou":
        # axis-aligned intersection (`geometry.aligned_intersection`)
        aw = det_box[:, 3] * det_box[:, 4]
        tw = pred[:, 3] * pred[:, 4]
        iw = (
            np.minimum(det_box[:, 0:1] + aw[:, None] * 0.5,
                       (pred[:, 0] + tw * 0.5)[None, :])
            - np.maximum(det_box[:, 0:1] - aw[:, None] * 0.5,
                         (pred[:, 0] - tw * 0.5)[None, :])
        )
        ih = (
            np.minimum(det_box[:, 1:2] + det_box[:, 4:5] * 0.5,
                       (pred[:, 1] + pred[:, 4] * 0.5)[None, :])
            - np.maximum(det_box[:, 1:2] - det_box[:, 4:5] * 0.5,
                         (pred[:, 1] - pred[:, 4] * 0.5)[None, :])
        )
        inter = np.where((iw > 0.0) & (ih > 0.0), iw * ih, np.float32(0.0))
        union = ((aw * det_box[:, 4])[:, None] + (tw * pred[:, 4])[None, :]
                 - inter)
        valid = inter > 0.0
        iou = np.where(valid, inter / np.where(valid, union, np.float32(1.0)),
                       np.float32(0.0))
        m = iou * conf[:, None]
        valid &= m >= np.float32(cfg.iou_threshold)
        return np.where(valid & compat, m, np.float32(0.0))

    # Mahalanobis (`sort/metric.rs:57-71`): inverted chi2-gated cost / conf
    mp = state.kf.mean_pos[cols]
    cpp = state.kf.cpp[cols]
    r = _stds(1.0, 1e-1, mp[..., 4], cfg.position_weight) ** 2
    S = cpp + r  # [C, 5]
    nu = det_box[:, None, :] - mp[None, :, :]
    d2 = np.sum(nu * nu / S[None, :, :], axis=-1)  # [D, C]
    cost = np.where(d2 > _CHI2_GATE, np.float32(0.0),
                    np.float32(CHI2_UPPER_BOUND) - d2)
    m = cost / conf[:, None]
    # too_far prune (`bbox.rs:452-462`)
    md = _radius(det_box)[:, None] + _radius(pred)[None, :]
    tf = _center_dist2(det_box, pred) > md * md
    return np.where(~tf & compat, m, np.float32(0.0))


def _radius(b):
    hw = b[..., 3] * b[..., 4] * np.float32(0.5)
    hh = b[..., 4] * np.float32(0.5)
    return np.sqrt(hw * hw + hh * hh)


def _center_dist2(a, b):
    dx = a[:, 0:1] - b[None, :, 0]
    dy = a[:, 1:2] - b[None, :, 1]
    return dx * dx + dy * dy


# ---------------------------------------------------------------------------
# Assignment: dominance reduction + component decomposition + exact JV
# ---------------------------------------------------------------------------

def _solve_components(W: np.ndarray, theta: float) -> np.ndarray:
    """Exact solution of the augmented LP, per bipartite component.

    Returns per-row target column index into W, or -1 for "new track".
    Columns with max weight < theta are dropped first (dominance: every row
    owns a private diagonal worth theta, so an optimum never pays < theta
    for a shared column); the remainder splits into connected components
    solved independently — identical optimum, tiny LAPs.
    """
    d, c = W.shape
    out = np.full((d,), -1, np.int64)
    if c == 0:
        return out
    theta = np.float32(theta)
    keep = np.flatnonzero(W.max(axis=0) >= theta)
    if keep.size == 0:
        return out
    Wk = W[:, keep]
    edge = Wk > 0.0
    rows_live = np.flatnonzero(edge.any(axis=1))
    if rows_live.size == 0:
        return out
    Wk = Wk[rows_live]
    edge = edge[rows_live]

    # exclusive rows: none of my columns is contested -> take my best column
    col_deg = edge.sum(axis=0)
    exclusive = ~(edge & (col_deg[None, :] > 1)).any(axis=1)
    if exclusive.any():
        er = np.flatnonzero(exclusive)
        best = np.argmax(Wk[er], axis=1)
        w_best = Wk[er, best]
        ok = w_best >= theta
        out[rows_live[er[ok]]] = keep[best[ok]]
    rest = np.flatnonzero(~exclusive)
    if rest.size == 0:
        return out

    # connected components over the contested remainder
    sub = edge[rest]
    n_r = rest.size
    labels = np.full((n_r,), -1, np.int64)
    ncols = sub.shape[1]
    col_seen = np.zeros((ncols,), bool)
    comp = 0
    for r0 in range(n_r):
        if labels[r0] >= 0:
            continue
        frontier = np.zeros((n_r,), bool)
        frontier[r0] = True
        members = frontier.copy()
        while frontier.any():
            cols_hit = sub[frontier].any(axis=0) & ~col_seen
            col_seen |= cols_hit
            nxt = (sub[:, cols_hit].any(axis=1)) & ~members
            members |= nxt
            frontier = nxt
        labels[members] = comp
        comp += 1

    for cidx in range(comp):
        rr = np.flatnonzero(labels == cidx)  # into rest
        cc = np.flatnonzero(sub[rr].any(axis=0))  # into keep-space
        nr, nc = rr.size, cc.size
        a = np.zeros((nr, nr + nc), np.float32)
        a[np.arange(nr), np.arange(nr)] = theta
        a[:, nr:] = Wk[rest[rr]][:, cc]
        sol = lap_max(a)
        matched = sol >= nr
        tgt = np.where(matched, sol - nr, 0)
        gr = rows_live[rest[rr]]
        out[gr[matched]] = keep[cc[tgt[matched]]]
    return out


# ---------------------------------------------------------------------------
# The host step
# ---------------------------------------------------------------------------

def host_sort_step(
    cfg: SortConfig,
    state: SortState,  # leaves are np.ndarray
    det_box: np.ndarray,  # [D, 5] f32 (no padding)
    det_conf: np.ndarray,  # [D] f32
    epoch: int,
) -> Tuple[SortState, dict]:
    """One SORT epoch on the host in one native call; mutates the array
    leaves of `state` in place and returns (state', outputs).  Semantics
    == `sort_step.sort_step`."""
    nid, slot, track_id, is_new, pred_box, length = native.sort_step_host(
        cfg, state, det_box, det_conf, int(epoch))
    out = {"slot": slot, "track_id": track_id, "is_new": is_new,
           "pred_box": pred_box, "length": length}
    return dataclasses.replace(state, next_id=np.array(nid, np.int32)), out


def host_sort_step_numpy(
    cfg: SortConfig,
    state: SortState,  # leaves are np.ndarray
    det_box: np.ndarray,  # [D, 5] f32 (no padding)
    det_conf: np.ndarray,  # [D] f32
    epoch: int,
) -> Tuple[SortState, dict]:
    """`host_sort_step` in NumPy, op for op the JAX module's NumPy path:
    mutates the array leaves of `state` in place and returns (state',
    outputs)."""
    d = det_box.shape[0]
    det_box = np.ascontiguousarray(det_box, np.float32)
    det_conf = np.ascontiguousarray(det_conf, np.float32)

    active = state.active
    delta_ok = (np.int32(epoch) - state.last_epoch) <= cfg.max_idle_epochs
    compat_col = active & delta_ok
    cols = np.flatnonzero(compat_col)

    W = _host_weights(cfg, state, det_box, det_conf, epoch, cols)
    tgt_col = _solve_components(W, cfg.new_track_threshold)  # [D] into cols
    matched = tgt_col >= 0
    if cols.size:
        tgt = np.where(matched, cols[np.where(matched, tgt_col, 0)], 0)
    else:
        tgt = np.zeros((d,), np.int64)

    # --- slot allocation --------------------------------------------------
    is_new = ~matched
    n_new = int(is_new.sum())
    free = np.flatnonzero(~active)
    if n_new > free.size:
        raise RuntimeError(
            f"track store overflow: {n_new} new tracks, {free.size} free "
            f"slots (capacity {state.capacity})"
        )
    slot = tgt.copy()
    slot[is_new] = free[:n_new]

    # --- Kalman: matched rows step their track state, new rows initiate --
    kf = state.kf
    mp = kf.mean_pos[slot].copy()
    mv = kf.mean_vel[slot].copy()
    cpp = kf.cpp[slot].copy()
    cpv = kf.cpv[slot].copy()
    cvv = kf.cvv[slot].copy()
    if n_new:
        imp, imv, icpp, icpv, icvv = _kf_initiate(cfg, det_box[is_new])
        mp[is_new] = imp
        mv[is_new] = imv
        cpp[is_new] = icpp
        cpv[is_new] = icpv
        cvv[is_new] = icvv
    mp, mv, cpp, cpv, cvv = _kf_predict(cfg, mp, mv, cpp, cpv, cvv)
    mp, mv, cpp, cpv, cvv = _kf_update(cfg, mp, mv, cpp, cpv, cvv, det_box)
    pred_box = mp

    new_length = np.where(matched, state.length[slot] + 1, 1).astype(np.int32)
    nid0 = int(state.next_id)
    new_ids = np.where(
        matched, state.track_id[slot],
        nid0 + np.cumsum(is_new.astype(np.int32)),
    ).astype(np.int32)

    # --- in-place state write-back ---------------------------------------
    kf.mean_pos[slot] = mp
    kf.mean_vel[slot] = mv
    kf.cpp[slot] = cpp
    kf.cpv[slot] = cpv
    kf.cvv[slot] = cvv
    state.pred_box[slot] = pred_box
    state.obs_box[slot] = det_box
    state.conf[slot] = det_conf
    state.active[slot] = True
    state.last_epoch[slot] = epoch
    state.length[slot] = new_length
    state.track_id[slot] = new_ids
    h = state.history
    hix = (new_length - 1) % h
    state.hist_obs[slot, hix] = det_box
    state.hist_pred[slot, hix] = pred_box
    state.hist_conf[slot, hix] = det_conf

    out = {
        "slot": slot.astype(np.int32),
        "track_id": new_ids,
        "is_new": is_new,
        "pred_box": pred_box,
        "length": new_length,
    }
    return dataclasses.replace(
        state, next_id=np.array(nid0 + n_new, np.int32)), out


def state_to_host(state):
    """A state of tensors (any device) -> mutable C-contiguous numpy
    leaves, copied."""
    return map_tensors(
        lambda t: np.array(t.detach().cpu().numpy(), order="C"), state)


def state_to_device(state, device) -> SortState:
    """numpy leaves -> tensors on `device`, copied."""
    return map_tensors(lambda a: torch.tensor(np.asarray(a), device=device),
                       state)


def as_tensors(state):
    """A state with numpy leaves as CPU tensors sharing their memory (an
    in-place write goes through to the arrays); tensors stay as they are."""
    return map_tensors(
        lambda a: a if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.asarray(a)), state)


def host_grow(state, new_capacity: int):
    """The numpy-leaf store at `new_capacity` slots; the new slots are
    zero, so inactive."""
    t = state.capacity
    assert new_capacity > t

    def pad(a):
        if np.ndim(a) == 0:
            return a
        pads = [(0, new_capacity - t)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, pads)

    return map_tensors(pad, state)
