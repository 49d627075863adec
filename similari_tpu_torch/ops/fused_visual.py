"""Fused VisualSORT frame: ReID gallery matching, cascade voting and the
state update for a chunk of C frames per launch (mirrors
`similari_tpu/ops/pallas_visual.py`).

`fused_visual_chunk` launches two CUDA kernels for CUDA tensors: the
chunk's gallery products (`ops/gallery_dots.py::gallery_dots`), then the
frame loop `fused_visual_kernel` (`csrc/fused_track.cu`), which gathers
each gated pair's dot product and norms from them.  The frame loop runs
the chunk on one thread-block cluster of VISUAL_CLUSTER blocks, the slots
dealt to the blocks in turn.  For CPU tensors it runs the plain PyTorch
version, `fused_visual_chunk_plain`.  Per frame
both compute: the positional metric (aligned IoU, or Mahalanobis against the
stored Kalman state) with spatio-temporal constraints; K per-lane gallery
distances (euclidean or cosine, f32 or bf16-rounded inputs) gated by
quality, area, own-area share and track maturity; the greedy best-fit claim
in closed form; the forward auction on the positional remainder; free-slot
allocation; the Kalman step; gallery insert with quality-sorted eviction.

Scope, as the reference kernel's: axis-aligned boxes, history depth 1,
own-area shares precomputed when own-area gating is on.  Shapes: at most
MAX_ROWS rows per frame, MAX_LANES lanes, and a block's shared arrays
within MAX_SMEM with every slice in device memory (`check_visual_shape`,
before any launch on every device).

The state travels as a tuple (see `state_to_tuple`): the 12 SORT columns
of `fused_sort.state_to_tuple`, then feats f32[T,K,F], feat_quality
[T,K], feat_valid i32[T,K], collected, voting_type, last_feat f32[T,F],
last_feat_valid i32[T], next_id[1].
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from .fused_sort import (MAX_ROWS, MAX_SMEM, NEG, STEP_HINT,
                         aligned_iou, allocate_slots, augmented, carve_bytes,
                         check_chunk_inputs, check_prof, forward_auction_plain,
                         kalman_rows, pointers, sanitize_boxes,
                         sort_state_shapes, write_rows)
from .gallery_dots import f32_dots, gallery_dots, round_bf16
from .kalman import KalmanState, calculate_cost
from . import visual_votes as vv
from ..trackers.visual_state import VisualState
from ..trackers.visual_step import VisualConfig
from ..utils.profiling import count, keep, span, spanned

_F32, _I32 = torch.float32, torch.int32
_BIG = 3.0e38

VisualTuple = Tuple[torch.Tensor, ...]

# the phases of a frame in `fused_visual_kernel`, in order; a profiled
# launch stamps the start of the frame and the end of each into an int64
# [C, PROF_WIDTH] buffer (`csrc/fused_track.cu::ST_*`), and the frame's
# cluster barriers into its last column
PHASES = ("rows and tracks", "lists", "positional pass", "norms",
          "gallery distances", "votes", "argmaxes", "auction",
          "slots and KF", "state write")
PROF_WIDTH = len(PHASES) + 2
# the frame loop's cluster (`csrc/fused_track.cu`): blocks, threads per
# block; slot t lies in block t % VISUAL_CLUSTER
VISUAL_CLUSTER, VISUAL_THREADS = 16, 512
# where a block keeps its data (`fused_visual_chunk.plan["storage"]`, bits:
# 4 the auction's column arrays, 2 its state slice, 1 its [D, Tc] matrices
# in shared memory; the rest in device memory)
STORAGE_BITS = ((4, "column arrays"), (2, "state"), (1, "matrices"))


def storage_name(storage: int) -> str:
    """What a block of the cluster keeps in shared memory under
    `storage`."""
    kept = [name for bit, name in STORAGE_BITS if storage & bit]
    return (", ".join(kept) or "nothing") + " in shared memory"


def check_visual_scope(cfg: VisualConfig) -> None:
    if cfg.oriented:
        raise NotImplementedError(
            "the fused kernel matches aligned boxes only; oriented boxes run "
            "on the general step (trackers/visual_step.py::visual_scan)")
    if cfg.own_area_on_device:
        raise NotImplementedError(
            "the fused kernel takes precomputed own-area shares; shares "
            "computed on the device run on the general step "
            "(trackers/visual_step.py::visual_scan)")
    if cfg.positional_kind not in ("iou", "maha"):
        raise ValueError(f"positional_kind {cfg.positional_kind!r}")
    if cfg.visual_kind not in ("euclidean", "cosine"):
        raise ValueError(f"visual_kind {cfg.visual_kind!r}")
    if cfg.feature_precision not in ("f32", "bf16"):
        raise ValueError(f"feature_precision {cfg.feature_precision!r}")
    if len(cfg.constraints) > 8:
        raise ValueError("at most 8 spatio-temporal constraints")


MAX_LANES = 31  # gallery lanes per track: bits of a per-track int mask


def visual_smem_bytes(d: int, t: int, k: int, storage: int) -> int:
    """Shared bytes per block of `VisualSmem::carve` (`csrc/fused_track.cu`)
    at D = d rows, T = t slots, K = k gallery lanes and the storage bits
    (the library's `fused_visual_plan` gives the same count)."""
    g = VISUAL_CLUSTER
    tc = -(-t // g)
    mw, tw = -(-tc // 32), -(-t // 32)
    counts = ([5 * d] + [d] * 5 + [d] * 18 + [(d, 8)] + [d] * 3
              + [2 * d, 2, (2 * d, 16)])
    if storage & 4:
        counts += [d + t, d + t, (d + t, 8)]
    counts += ([tc] * 9 + [k * tc] * 2 + [(VISUAL_THREADS, 8)]
               + [2 * mw, g * mw, tw] + [2] * 3 + [g] * 3 + [32, 32]
               + [4, 1])
    if storage & 2:
        counts += [5 * tc] * 7 + [tc] * 5 + [k * tc] * 2 + [tc] * 3
    if storage & 1:
        counts += [d * tc, d * tc, (d * tc, 1)]
    return carve_bytes(counts)


def visual_storage(d: int, t: int, k: int):
    """(storage, shared bytes per block) that `visual_storage` in
    `csrc/fused_track.cu` chooses: the first of 7, 6, ..., 0 that fits;
    storage -1 (with the bytes of 0) when none fits."""
    for s in range(7, -1, -1):
        nbytes = visual_smem_bytes(d, t, k, s)
        if nbytes <= MAX_SMEM:
            return s, nbytes
    return -1, nbytes


def check_visual_shape(d: int, t: int, k: int):
    """Raise ValueError, before any launch and alike on every device, for
    a shape `fused_visual_kernel` does not take: more than MAX_ROWS rows
    per frame, more than MAX_LANES lanes, or a block's shared arrays past
    MAX_SMEM with every slice in device memory.  Returns
    `visual_storage(d, t, k)`."""
    if d > MAX_ROWS:
        raise ValueError(f"the fused VisualSORT kernel takes at most "
                         f"{MAX_ROWS} rows per frame, got D={d}" + STEP_HINT)
    if k > MAX_LANES:
        raise ValueError(f"the fused VisualSORT kernel takes at most "
                         f"{MAX_LANES} gallery lanes per track, got K={k}"
                         + STEP_HINT)
    storage, nbytes = visual_storage(d, t, k)
    if storage < 0:
        raise ValueError(f"the fused VisualSORT kernel's shared arrays at "
                         f"D={d}, T={t}, K={k} take {nbytes} bytes per "
                         f"block, past the {MAX_SMEM} bytes a block may use"
                         + STEP_HINT)
    return storage, nbytes


def _gallery_distances(cfg: VisualConfig, feat, gf):
    """[K] lists of (w[D,T], ok[D,T]) for every pair."""
    bf16 = cfg.feature_precision == "bf16"
    qn = (feat * feat).sum(dim=1)
    q_in = round_bf16(feat) if bf16 else feat
    out = []
    for i in range(gf.shape[1]):
        g = gf[:, i, :]
        gn = (g * g).sum(dim=1)
        dot = f32_dots(q_in, round_bf16(g) if bf16 else g)
        if cfg.visual_kind == "euclidean":
            w = torch.sqrt(torch.clamp(qn[:, None] + gn[None, :]
                                       - 2.0 * dot, min=0.0))
            ok = w <= cfg.visual_threshold
        else:
            den = torch.sqrt(qn)[:, None] * torch.sqrt(gn)[None, :]
            sim = dot / torch.where(den > 0, den, 1.0)
            ok = sim >= cfg.visual_threshold
            w = 1.0 - sim
        out.append((w, ok))
    return out


def _max_distance(dists, valids) -> torch.Tensor:
    """The largest gallery distance over the pairs that pass, or NEG."""
    max_dist = torch.tensor(NEG, dtype=_F32, device=valids[0].device)
    for (w, _), v in zip(dists, valids):
        max_dist = torch.maximum(max_dist, torch.where(v, w, NEG).max())
    return max_dist


def _visual_frame_plain(cfg: VisualConfig, st: list, box, conf, valid, feat,
                        fvalid, qual, oa, epoch: int):
    d = box.shape[0]
    t, k = st[13].shape
    dev = box.device
    thr = cfg.new_track_threshold
    dvalid = valid > 0
    featok = fvalid > 0
    box = sanitize_boxes(box, dvalid)
    active = st[8] > 0
    last = st[9]
    pred = st[5]
    compat = active & ((epoch - last) <= cfg.max_idle_epochs)
    if cfg.recycle_idle:
        active = compat
    # ---- compatibility + positional weights -------------------------------
    hwd, hhd = box[:, 3] * box[:, 4] * 0.5, box[:, 4] * 0.5
    r_det = torch.sqrt(hwd * hwd + hhd * hhd)
    hwt, hht = pred[:, 3] * pred[:, 4] * 0.5, pred[:, 4] * 0.5
    r_trk = torch.sqrt(hwt * hwt + hht * hht)
    dx = box[:, 0:1] - pred[:, 0][None, :]
    dy = box[:, 1:2] - pred[:, 1][None, :]
    cd2 = dx * dx + dy * dy
    rsum = r_det[:, None] + r_trk[None, :]
    if cfg.constraints:
        delta = epoch - last
        allowed = torch.full((t,), _BIG, dtype=_F32, device=dev)
        for dd, max_dist in sorted(cfg.constraints, reverse=True):
            allowed = torch.where(delta <= dd, float(max_dist), allowed)
        d2r = torch.sqrt(cd2) / torch.sqrt(rsum * rsum + 1e-5)
        compat_dt = compat[None, :] & (d2r <= allowed[None, :])
    else:
        compat_dt = compat[None, :].expand(d, t)
    cc = torch.clamp(conf, min=cfg.positional_min_confidence)
    if cfg.positional_kind == "iou":
        iou, inter = aligned_iou(box, pred)
        m = iou * cc[:, None]
        p_valid = compat_dt & (inter > 0) & (m >= thr)
    else:
        kf = KalmanState(*st[0:5])
        d2 = cfg.kalman_spec.distance_matrix(kf, box, s_floor=1e-30)
        m = calculate_cost(d2, inverted=True) / cc[:, None]
        p_valid = compat_dt & ~(cd2 > rsum * rsum)
    P = torch.where(p_valid, m, 0.0)
    # ---- candidate feature gates -------------------------------------------
    area_ok = box[:, 3] * box[:, 4] * box[:, 4] >= cfg.visual_minimal_area
    use = (featok & dvalid & (qual >= cfg.visual_minimal_quality_use)
           & (oa >= cfg.own_area_use) & area_ok)
    collect = (featok & (qual >= cfg.visual_minimal_quality_collect)
               & (oa >= cfg.own_area_collect) & area_ok)
    # ---- gallery distances + votes ------------------------------------------
    track_gate = st[15] >= cfg.visual_minimal_track_length
    dists = _gallery_distances(cfg, feat, st[12])
    gate = use[:, None] & compat_dt & track_gate[None, :]
    lanes = [gate & (st[14][:, i] > 0)[None, :] for i in range(k)]
    n_pairs = sum(int(x.sum()) for x in lanes)  # the pairs the kernel scores
    valids = [x & ok for x, (_, ok) in zip(lanes, dists)]
    max_dist = _max_distance(dists, valids)
    votes = torch.zeros((d, t), dtype=torch.int64, device=dev)
    weight = torch.zeros((d, t), dtype=_F32, device=dev)
    for (w, _), v in zip(dists, valids):
        votes = votes + v.to(torch.int64)
        weight = weight + torch.where(v, max_dist - w, 0.0)
    # ---- greedy best-fit claim in closed form ----------------------------
    t1, has_any, wins, claimed = vv.best_fit(votes, weight, dvalid,
                                             cfg.visual_min_votes)
    rows = torch.arange(d, device=dev)
    # ---- positional auction on the remainder -----------------------------
    row_open = dvalid & ~has_any
    col_open = active & ~claimed
    P_m = torch.where(row_open[:, None] & col_open[None, :] & p_valid, P, 0.0)
    r2c, rounds, bids = forward_auction_plain(augmented(P_m, dvalid, thr),
                                              dvalid)
    ptgt = torch.clamp(r2c - d, 0, t - 1)
    pos = row_open & (r2c >= d) & (P_m[rows, ptgt] >= thr)
    matched = wins | pos
    tgt = torch.where(wins, t1, ptgt)
    vt = torch.where(wins, 0, 1).to(_I32)
    # ---- slots, Kalman step, ids -----------------------------------------
    is_new = dvalid & ~matched
    slot, new_rank, n_new, overflow = allocate_slots(is_new, matched, tgt,
                                                     ~active)
    u = kalman_rows(cfg.kalman_spec, st, slot, matched, box)
    new_len = torch.where(matched, st[10][slot] + 1, 1)
    new_ids = torch.where(matched, st[11][slot], st[19][0] + new_rank)
    # ---- gallery bookkeeping: eviction, collect gates -------------------
    kcols = torch.arange(k, device=dev)
    gal_v = (st[14][slot] > 0) & matched[:, None]
    gal_q = torch.where(dvalid[:, None], st[13][slot], 0.0)
    evict_needed = gal_v.sum(dim=1) >= k
    minq = torch.where(gal_v, gal_q, _BIG).min(dim=1).values
    evict_k = torch.where(gal_v & (gal_q <= minq[:, None]), kcols, k).min(
        dim=1).values
    gal_v = gal_v & ~(evict_needed[:, None] & (kcols == evict_k[:, None]))
    # a brand-new track's first feature bypasses the collect gate
    keep_new = featok & (is_new | collect)
    free_k = torch.where(~gal_v, kcols, k).min(dim=1).values
    free_k = torch.where(free_k == k, 0, free_k)
    new_lane = (kcols == free_k[:, None]) & keep_new[:, None]
    final_v = gal_v | new_lane
    final_q = torch.where(new_lane, qual[:, None], gal_q)
    # ---- state write (dropped on overflow) --------------------------------
    if cfg.recycle_idle:
        st[8] = active.to(_I32)
    if not bool(overflow):
        w = dvalid
        sl = slot[w]
        write_rows(st, w, sl, u, box, conf, epoch, new_len, new_ids)
        st[13][sl] = final_q[w]
        st[14][sl] = final_v[w].to(_I32)
        st[15][sl] = final_v[w].sum(dim=1).to(_I32)
        st[16][sl] = vt[w]
        st[17][sl] = feat[w]
        st[18][sl] = featok[w].to(_I32)
        nl = w & new_lane.any(dim=1)
        st[12][slot[nl], free_k[nl]] = feat[nl]
    st[19] = st[19] + n_new.to(_I32)
    return (new_ids.to(_I32), slot.to(_I32), u.mean_pos, vt,
            is_new.to(_I32), new_len.to(_I32), overflow,
            torch.tensor([rounds, bids, n_pairs], dtype=_I32))


def fused_visual_chunk_plain(cfg: VisualConfig, state: VisualTuple, box,
                             conf, valid, feat, fvalid, qual, oa,
                             epoch0: int):
    """Plain PyTorch version of the fused VisualSORT chunk (same outputs as
    `fused_visual_chunk`), on any device."""
    st = [x.clone() for x in state]
    outs = [_visual_frame_plain(cfg, st, box[s], conf[s], valid[s], feat[s],
                                fvalid[s], qual[s], oa[s], epoch0 + s)
            for s in range(box.shape[0])]
    ids, slots, pred, vt, newf, length, ovf, stats = (
        torch.stack(x) for x in zip(*outs))
    return (tuple(st), ids, slots, pred, vt, newf, length, ovf,
            stats.to(box.device))


def visual_state_shapes(t: int, k: int, f: int):
    return (sort_state_shapes(t)[:12]
            + [((t, k, f), _F32), ((t, k), _F32), ((t, k), _I32),
               ((t,), _I32), ((t,), _I32), ((t, f), _F32), ((t,), _I32),
               ((1,), _I32)])


@spanned("fused_visual_chunk")
def fused_visual_chunk(cfg: VisualConfig, state: VisualTuple, box, conf,
                       valid, feat, fvalid, qual, oa, epoch0: int,
                       prof=None):
    """C frames of VisualSORT from `state` (not modified).

    box f32[C,D,5], conf f32[C,D], valid bool/int[C,D], feat f32[C,D,F],
    fvalid bool/int[C,D], qual/oa f32[C,D]; frame s runs at epoch
    `epoch0 + s`.  Returns (state', ids, slots, pred f32[C,D,5], voting
    type, is_new, length (i32[C,D] each), overflow bool[C], stats i32[C,3])
    where stats holds the auction rounds, the bids made and the gated
    (candidate, gallery lane) pairs per frame, the pairs whose distance
    the kernel scores.
    CUDA tensors launch the kernels; CPU tensors run the plain version.
    `prof`, an int64 [C, PROF_WIDTH] CUDA tensor, receives the
    kernel's phase stamps (ns of the device's global timer) and cluster
    barriers.  A launch records its plan in `fused_visual_chunk.plan`:
    cluster size, threads per block, storage (`storage_name`) and shared
    bytes per block.
    """
    check_visual_scope(cfg)
    valid, fvalid = valid.to(_I32), fvalid.to(_I32)
    t, k, f = state[12].shape
    check_chunk_inputs(state, box, conf, valid, visual_state_shapes(t, k, f),
                       (feat, fvalid, qual, oa))
    c, d = box.shape[:2]
    if feat.shape != (c, d, f) or feat.dtype != _F32:
        raise ValueError(f"feat must be float32 [C, D, {f}]")
    for x in (fvalid, qual, oa):
        if x.shape != (c, d):
            raise ValueError("fvalid, qual and oa must be [C, D]")
    if qual.dtype != _F32 or oa.dtype != _F32:
        raise TypeError("qual and oa must be float32")
    check_prof(prof, box, PROF_WIDTH)
    storage, smem_bytes = check_visual_shape(d, t, k)
    if box.device.type == "cpu":
        return fused_visual_chunk_plain(cfg, state, box, conf, valid, feat,
                                        fvalid, qual, oa, epoch0)
    if box.device.type != "cuda":
        raise ValueError(f"unsupported device {box.device}")
    from .._build import check, library

    lib = library()
    ins = [x.contiguous() for x in (box, conf, valid, feat, fvalid, qual, oa)]
    with span("fused_visual.clone"):
        st = tuple(x.contiguous().clone() for x in state)  # updated in place
    dev = box.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = [empty((c, d), _I32), empty((c, d), _I32), empty((c, d, 5), _F32),
            empty((c, d), _I32), empty((c, d), _I32), empty((c, d), _I32),
            empty((c,), _I32), empty((c, 3), _I32)]
    # device-memory scratch only for what the plan keeps out of shared
    # memory: the blocks' [D, Tc] matrices (two f32, one byte), the column
    # arrays ([G, 4 (D+T)] words)
    g, tc = VISUAL_CLUSTER, -(-t // VISUAL_CLUSTER)
    mats = None if storage & 1 else empty((g * d * tc * 9 + 3) // 4, _F32)
    cols = None if storage & 4 else empty((g, 4 * (d + t)), _I32)
    # every product the chunk can need, from the launch-start gallery
    dots, norms = gallery_dots(ins[3].view(c * d, f), st[12].view(t * k, f),
                               cfg.feature_precision == "bf16", d)
    cons = sorted(cfg.constraints)
    n_cons = len(cons)
    dd = (ctypes.c_int * max(n_cons, 1))(*[int(a) for a, _ in cons])
    md = (ctypes.c_float * max(n_cons, 1))(*[float(b) for _, b in cons])
    pw, vw = cfg.position_weight, cfg.velocity_weight
    # the launch and its attributes
    with span("fused_visual.launch"), torch.cuda.device(dev):
        code = lib.fused_visual_launch(
            *pointers(*ins, *st, *outs),
            *(None if x is None else x.data_ptr() for x in (mats, cols)),
            *pointers(dots, norms),
            c, d, t, k, f, int(epoch0), cfg.max_idle_epochs,
            int(cfg.recycle_idle), cfg.visual_minimal_track_length,
            cfg.visual_min_votes, int(cfg.positional_kind == "maha"),
            int(cfg.visual_kind == "euclidean"), n_cons,
            cfg.new_track_threshold, cfg.positional_min_confidence,
            cfg.visual_threshold, cfg.visual_minimal_area,
            cfg.visual_minimal_quality_use,
            cfg.visual_minimal_quality_collect,
            cfg.own_area_use, cfg.own_area_collect,
            2.0 * pw, 1.0 * pw, 10.0 * vw, 1.0 * vw,
            ctypes.cast(dd, ctypes.c_void_p), ctypes.cast(md, ctypes.c_void_p),
            None if prof is None else prof.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        check(code, "fused_visual_launch")
    fused_visual_chunk.plan = dict(cluster=VISUAL_CLUSTER,
                                   threads=VISUAL_THREADS, storage=storage,
                                   smem_bytes=smem_bytes)
    count("fused_visual.launches")
    ids, slots, pred, vt, newf, length, ovf, stats = outs
    return st, ids, slots, pred, vt, newf, length, ovf > 0, stats


fused_visual_chunk.plan = None


def state_to_tuple(state: VisualState) -> VisualTuple:
    return (
        (state.kf.mean_pos, state.kf.mean_vel, state.kf.cpp, state.kf.cpv,
         state.kf.cvv, state.pred_box, state.obs_box, state.conf,
         state.active.to(_I32), state.last_epoch, state.length,
         state.track_id,
         state.feats.to(_F32), state.feat_quality,
         state.feat_valid.to(_I32), state.collected, state.voting_type,
         state.hist_feat[:, 0, :].to(_F32),
         state.hist_feat_valid[:, 0].to(_I32),
         state.next_id.reshape(1).to(_I32))
    )


def tuple_to_state(tup: VisualTuple, template: VisualState) -> VisualState:
    (mp, mv, cpp, cpv, cvv, pred, obs, tconf, active, last, length, tid,
     gf, gq, gv, coll, vt, lastf, lastfv, nid) = tup
    fdt = template.feats.dtype
    return dataclasses.replace(
        template,
        kf=KalmanState(mp, mv, cpp, cpv, cvv),
        pred_box=pred, obs_box=obs, conf=tconf,
        active=active > 0, last_epoch=last, length=length, track_id=tid,
        hist_obs=obs[:, None, :], hist_pred=pred[:, None, :],
        hist_conf=tconf[:, None],
        next_id=nid.reshape(()),
        feats=gf.to(fdt), feat_quality=gq, feat_valid=gv > 0,
        collected=coll, voting_type=vt,
        hist_feat=lastf[:, None, :].to(template.hist_feat.dtype),
        hist_feat_valid=(lastfv > 0)[:, None],
    )


@spanned("fused_visual_scan")
def fused_visual_scan(cfg: VisualConfig, state: VisualState, det_box,
                      det_conf, det_valid, det_feat, det_feat_valid,
                      det_quality, det_own_area, epoch0: int, chunk: int):
    """Chunks of `chunk` frames through `fused_visual_chunk`, epochs
    consecutive from `epoch0`.  Returns (state', (ids, slots, pred, vt,
    is_new, length, overflow)) with [S, D, ...] outputs."""
    if state.history != 1:
        raise NotImplementedError(
            "the fused kernel keeps history depth 1; deeper histories run "
            "on the general step (trackers/visual_step.py::visual_scan)")
    steps = det_box.shape[0]
    if steps % chunk:
        raise ValueError("steps must be a multiple of the chunk size")
    tup = state_to_tuple(state)
    outs = []
    for c0 in range(0, steps, chunk):
        sl = slice(c0, c0 + chunk)
        tup, *o = fused_visual_chunk(
            cfg, tup, det_box[sl], det_conf[sl], det_valid[sl],
            det_feat[sl].to(_F32), det_feat_valid[sl], det_quality[sl],
            det_own_area[sl], epoch0 + c0)
        outs.append(o[:7])
        keep("fused_visual.stats", o[7])
    ids, slots, pred, vt, newf, length, ovf = (torch.cat(x) for x in zip(*outs))
    return tuple_to_state(tup, state), (ids, slots, pred, vt, newf, length,
                                        ovf)
