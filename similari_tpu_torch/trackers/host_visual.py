"""Host VisualSORT step: the interactive engine for per-call use
(mirrors `similari_tpu/trackers/host_visual.py`).

The same engine split as SORT (`host_sort.py`): this module runs the step
semantics of `visual_step.py` on a `VisualState` whose leaves are numpy
arrays:

* positional metric and compatible gate (`visual_sort/metric.rs:156-198`,
  `track_attributes.rs:188-208`);
* gallery feature distances as one sgemm over the compatible tracks'
  gallery lanes, TopN-style votes and weights (`metric.rs:200-225`,
  `voting/best.rs:92-103`);
* the cascade: the closed-form greedy best-fit claim (the general step's
  formulation), then the exact positional LP on the remainder by the
  dominance-reduced components of `host_sort._solve_components` on the
  port's C++ solver;
* gallery maintenance (eviction by quality, the collect gates, the
  first-feature bypass) and the block Kalman update.

Scope: f32 galleries (a bf16 `VisualSort` takes the device step).  Boxes
may be aligned or oriented: the rotated IoU is `host_geometry.py`'s.  The
own-area shares come in as `det_own_area`; the trackers compute them with
the f64 clipping oracle (`utils/clipping.py`).

`host_visual_step` takes the JAX module's split: a frame of at most
`NATIVE_MAX_DETECTIONS` detections runs in one call of the port's C++ step
(`native.py::visual_step_host`, `csrc/visualstep.cpp`), bit-equal to the
JAX native step; a larger frame runs `host_visual_step_numpy`, the NumPy
step op for op the JAX module's (one BLAS product for the gallery
distances).  That NumPy step is also the plain twin the tests hold the
native step against.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .. import native
from ..ops.kalman import CHI2_UPPER_BOUND
from .host_sort import (
    _CHI2_GATE,
    _kf_initiate,
    _kf_predict,
    _kf_update,
    _radius,
    _solve_components,
    _stds,
)
from .visual_state import VisualState

_NEG = np.float32(-1e30)
# the JAX module's split between its C++ step and its NumPy step, kept so
# that both packages take the same step (and round alike) on every frame
NATIVE_MAX_DETECTIONS = 128


def host_visual_step(
    cfg,
    state: VisualState,  # np leaves
    det_box: np.ndarray,  # [D, 5]
    det_conf: np.ndarray,  # [D]
    det_feat: np.ndarray,  # [D, F]
    det_feat_valid: np.ndarray,  # [D] bool
    det_quality: np.ndarray,  # [D]
    det_own_area: np.ndarray,  # [D]
    epoch: int,
) -> Tuple[VisualState, dict]:
    """One VisualSORT epoch on the host; mutates the array leaves of
    `state` in place and returns (state', outputs).  Frames of at most
    `NATIVE_MAX_DETECTIONS` detections with an f32 gallery take the C++
    step, the rest `host_visual_step_numpy`."""
    dets = (det_box, det_conf, det_feat, det_feat_valid, det_quality,
            det_own_area)
    if not native_scope(state, det_box.shape[0]):
        return host_visual_step_numpy(cfg, state, *dets, epoch)
    nid, slot, tid, is_new, pred, length, vt = native.visual_step_host(
        cfg, state, *dets, int(epoch))
    out = {"slot": slot, "track_id": tid, "is_new": is_new,
           "pred_box": pred, "length": length, "voting_type": vt}
    return dataclasses.replace(state, next_id=np.array(nid, np.int32)), out


def native_scope(state: VisualState, d: int) -> bool:
    """Whether a frame of `d` detections on `state` takes the C++ step:
    at most `NATIVE_MAX_DETECTIONS` of them and an f32 gallery."""
    return d <= NATIVE_MAX_DETECTIONS and state.feats.dtype == np.float32


def host_visual_step_numpy(
    cfg,
    state: VisualState,  # np leaves
    det_box: np.ndarray,  # [D, 5]
    det_conf: np.ndarray,  # [D]
    det_feat: np.ndarray,  # [D, F]
    det_feat_valid: np.ndarray,  # [D] bool
    det_quality: np.ndarray,  # [D]
    det_own_area: np.ndarray,  # [D]
    epoch: int,
) -> Tuple[VisualState, dict]:
    """`host_visual_step` in NumPy, op for op the JAX module's NumPy
    path."""
    d = det_box.shape[0]
    k = state.gallery_size
    det_box = np.ascontiguousarray(det_box, np.float32)
    det_conf = np.ascontiguousarray(det_conf, np.float32)
    det_feat = np.ascontiguousarray(det_feat, np.float32)

    # ---- compatible columns ---------------------------------------------
    active = state.active
    delta = np.int32(epoch) - state.last_epoch
    cols = np.flatnonzero(active & (delta <= cfg.max_idle_epochs))
    c = cols.size
    pred = state.pred_box[cols]
    if cfg.constraints and c:
        allowed = np.full((c,), np.inf, np.float32)
        dd = delta[cols]
        for dlt, max_dist in sorted(cfg.constraints, reverse=True):
            allowed = np.where(dd <= dlt, np.float32(max_dist), allowed)
        rd = _radius(det_box)[:, None] + _radius(pred)[None, :]
        dx = det_box[:, 0:1] - pred[None, :, 0]
        dy = det_box[:, 1:2] - pred[None, :, 1]
        d2r = np.sqrt(dx * dx + dy * dy) / np.sqrt(rd * rd + np.float32(1e-5))
        compat = d2r <= allowed[None, :]
    else:
        compat = np.ones((d, c), bool)

    # ---- positional weights (`visual_sort/metric.rs:156-198`) ------------
    conf = np.maximum(det_conf, np.float32(cfg.positional_min_confidence))
    if cfg.positional_kind == "iou" and cfg.oriented:
        from .host_geometry import rotated_iou_matrix_np

        iou, pv = rotated_iou_matrix_np(det_box, pred)
        m = iou * conf[:, None]
        p_valid = pv & (m >= np.float32(cfg.iou_threshold)) & compat
    elif cfg.positional_kind == "iou":
        aw = det_box[:, 3] * det_box[:, 4]
        tw = pred[:, 3] * pred[:, 4]
        iw = (np.minimum(det_box[:, 0:1] + aw[:, None] * 0.5,
                         (pred[:, 0] + tw * 0.5)[None, :])
              - np.maximum(det_box[:, 0:1] - aw[:, None] * 0.5,
                           (pred[:, 0] - tw * 0.5)[None, :]))
        ih = (np.minimum(det_box[:, 1:2] + det_box[:, 4:5] * 0.5,
                         (pred[:, 1] + pred[:, 4] * 0.5)[None, :])
              - np.maximum(det_box[:, 1:2] - det_box[:, 4:5] * 0.5,
                           (pred[:, 1] - pred[:, 4] * 0.5)[None, :]))
        inter = np.where((iw > 0.0) & (ih > 0.0), iw * ih, np.float32(0.0))
        union = ((aw * det_box[:, 4])[:, None] + (tw * pred[:, 4])[None, :]
                 - inter)
        pv = inter > 0.0
        iou = np.where(pv, inter / np.where(pv, union, np.float32(1.0)),
                       np.float32(0.0))
        m = iou * conf[:, None]
        p_valid = pv & (m >= np.float32(cfg.iou_threshold)) & compat
    else:
        mp = state.kf.mean_pos[cols]
        cpp = state.kf.cpp[cols]
        r = _stds(1.0, 1e-1, mp[..., 4], cfg.position_weight) ** 2
        S = cpp + r
        nu = det_box[:, None, :] - mp[None, :, :]
        d2 = np.sum(nu * nu / S[None, :, :], axis=-1)
        cost = np.where(d2 > _CHI2_GATE, np.float32(0.0),
                        np.float32(CHI2_UPPER_BOUND) - d2)
        m = cost / conf[:, None]
        md = _radius(det_box)[:, None] + _radius(pred)[None, :]
        dx = det_box[:, 0:1] - pred[None, :, 0]
        dy = det_box[:, 1:2] - pred[None, :, 1]
        p_valid = compat & ~(dx * dx + dy * dy > md * md)
    P = np.where(p_valid, m, np.float32(0.0))

    # ---- candidate gates (`visual_sort/metric.rs:227-249`) ---------------
    area = det_box[:, 3] * det_box[:, 4] * det_box[:, 4]
    area_ok = area >= np.float32(cfg.visual_minimal_area)
    use_gate = (det_feat_valid
                & (det_quality >= np.float32(cfg.visual_minimal_quality_use))
                & (det_own_area >= np.float32(cfg.own_area_use)) & area_ok)
    collect_gate = (det_feat_valid
                    & (det_quality
                       >= np.float32(cfg.visual_minimal_quality_collect))
                    & (det_own_area >= np.float32(cfg.own_area_collect))
                    & area_ok)

    # ---- gallery distances + votes (`metric.rs:200-225`) -----------------
    if c:
        gal = state.feats[cols].reshape(c * k, -1).astype(np.float32)
        gal_live = state.feat_valid[cols].reshape(c * k)
        qn = np.einsum("df,df->d", det_feat, det_feat)
        gn = np.einsum("lf,lf->l", gal, gal)
        dot = det_feat @ gal.T  # [D, C*K]
        if cfg.visual_kind == "euclidean":
            w = np.sqrt(np.maximum(qn[:, None] + gn[None, :] - 2.0 * dot,
                                   0.0), dtype=np.float32)
            ok = w <= np.float32(cfg.visual_threshold)
        else:
            denom = np.sqrt(qn[:, None] * gn[None, :])
            sim = dot / np.where(denom > 0, denom, np.float32(1.0))
            ok = sim >= np.float32(cfg.visual_threshold)
            w = np.float32(1.0) - sim
        track_gate = (state.collected[cols]
                      >= cfg.visual_minimal_track_length)  # [C]
        valid3 = (use_gate[:, None, None]
                  & compat[:, :, None]
                  & track_gate[None, :, None]
                  & gal_live.reshape(1, c, k)
                  & ok.reshape(d, c, k))
        w3 = w.reshape(d, c, k)
        votes = valid3.sum(axis=2)
        any_valid = valid3.any()
        max_dist = np.float32(w3[valid3].max()) if any_valid else _NEG
        weight = np.where(valid3, max_dist - w3, np.float32(0.0)).sum(axis=2)
    else:
        votes = np.zeros((d, 0), np.int32)
        weight = np.zeros((d, 0), np.float32)

    # ---- closed-form greedy best-fit (== visual_step formulation) --------
    eligible = votes >= cfg.visual_min_votes
    if c:
        wm = np.where(eligible, weight, _NEG)
        t1 = np.argmax(wm, axis=1)
        has_any = eligible.any(axis=1)
        best_query = np.argmax(wm, axis=0)  # [C]
        wins_visual = has_any & (best_query[t1] == np.arange(d))
        claimed = np.zeros((c,), bool)
        claimed[t1[wins_visual]] = True
    else:
        t1 = np.zeros((d,), np.int64)
        has_any = np.zeros((d,), bool)
        wins_visual = has_any
        claimed = np.zeros((0,), bool)

    # ---- positional LP on the remainder ----------------------------------
    row_open = ~has_any
    W_m = np.where(row_open[:, None] & ~claimed[None, :], P, np.float32(0.0))
    tgt_col = _solve_components(W_m, cfg.new_track_threshold)
    pos_matched = tgt_col >= 0

    matched = wins_visual | pos_matched
    tgt_local = np.where(wins_visual, t1, np.where(pos_matched, tgt_col, 0))
    if c:
        tgt = cols[tgt_local]
    else:
        tgt = np.zeros((d,), np.int64)
    vt = np.where(wins_visual, 0, 1).astype(np.int32)  # VT_VISUAL/POSITIONAL

    # ---- slot allocation -------------------------------------------------
    is_new = ~matched
    n_new = int(is_new.sum())
    free = np.flatnonzero(~active)
    if n_new > free.size:
        raise RuntimeError(
            f"track store overflow: {n_new} new tracks, {free.size} free "
            f"slots (capacity {state.capacity})")
    slot = np.where(matched, tgt, 0)
    if n_new:
        slot[is_new] = free[:n_new]

    # ---- Kalman ----------------------------------------------------------
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
    new_ids = np.where(matched, state.track_id[slot],
                       nid0 + np.cumsum(is_new.astype(np.int32))
                       ).astype(np.int32)

    # ---- gallery update (`visual_sort/metric.rs:297-374`) ----------------
    gal_valid = np.where(matched[:, None], state.feat_valid[slot], False)
    gal_q = state.feat_quality[slot].copy()
    n_f = gal_valid.sum(axis=1)
    evict_needed = n_f >= k
    evict_k = np.argmin(np.where(gal_valid, gal_q, np.inf), axis=1)
    gal_valid[evict_needed, evict_k[evict_needed]] = False
    keep_new = det_feat_valid & (is_new | collect_gate)
    free_k = np.argmax(~gal_valid, axis=1)
    onehot_new = np.zeros((d, k), bool)
    onehot_new[np.arange(d), free_k] = True
    onehot_new &= keep_new[:, None]
    final_valid = gal_valid | onehot_new
    final_q = np.where(onehot_new, det_quality[:, None], gal_q)
    collected = final_valid.sum(axis=1).astype(np.int32)

    # ---- state write-back (slots are distinct by construction) -----------
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
    fk = state.feats[slot]  # [D, K, F] copy
    fk[keep_new, free_k[keep_new]] = det_feat[keep_new].astype(fk.dtype)
    state.feats[slot] = fk
    state.feat_quality[slot] = final_q
    state.feat_valid[slot] = final_valid
    state.collected[slot] = collected
    state.voting_type[slot] = vt
    h = state.history
    hix = (new_length - 1) % h
    state.hist_obs[slot, hix] = det_box
    state.hist_pred[slot, hix] = pred_box
    state.hist_conf[slot, hix] = det_conf
    state.hist_feat[slot, hix] = det_feat.astype(state.hist_feat.dtype)
    state.hist_feat_valid[slot, hix] = det_feat_valid

    out = {
        "slot": slot.astype(np.int32),
        "track_id": new_ids,
        "is_new": is_new,
        "pred_box": pred_box,
        "length": new_length,
        "voting_type": vt,
    }
    return dataclasses.replace(
        state, next_id=np.array(nid0 + n_new, np.int32)), out
