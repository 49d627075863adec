"""The general VisualSORT step and its scan (mirrors
`similari_tpu/trackers/visual_step.py`).

    (state, padded detections + features, epoch) -> (state', outputs)

One step: the positional metric of every (detection, track) pair (aligned
or oriented IoU x confidence, or inverted Mahalanobis cost / confidence
with the `too_far` prune) under the idle gate and the spatio-temporal
constraints; gallery feature distances (euclidean or cosine, f32 or
bf16-rounded inputs) gated by quality, own area, box area and track
maturity; the greedy best-fit claim in closed form (track t goes to its
heaviest candidate, so candidate d wins its best track t1 iff the heaviest
candidate of t1 is d; a candidate with any vote and no win becomes a new
track); the positional assignment on the remainder; free-slot allocation;
one masked Kalman step; the gallery insert with quality-sorted eviction and
the collect gates; ring histories of depth H.  Own-area shares are
computed inside the step when a gate is on and `own_area_backend` is
"device" (`ops/ownarea.py`).

Like `sort_step`, the step takes an optional leading scene axis (state
[S, ...], detections [S, D, ...], epochs int[S]), with every reduction per
scene; `parallel/mesh.py` builds the batched steps on it.  The fused
VisualSORT kernel (`ops/fused_visual.py::fused_visual_scan`) runs the
aligned, history-1 case of the same step for whole frame chunks.

The step's stages are spans of `utils/profiling.py`, in order:
`visual_step.weights` (positional weights and the candidate gates),
`.votes`, `.best_fit`, `.auction`, `.slots_kalman`, `.gallery`,
`.state_write`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from ..ops import assignment as asg
from ..ops import distances as dst
from ..ops import geometry as geo
from ..ops import kalman as kal
from ..ops import merge as mrg
from ..ops import ownarea as owna
from ..ops import visual_votes as vv
from .sort_step import (MAHALANOBIS_NEW_TRACK_THRESHOLD, _compat,
                        scene_epochs)
from .state import map_tensors
from .visual_state import VisualState
from ..utils.profiling import span

VT_VISUAL = 0
VT_POSITIONAL = 1


@dataclasses.dataclass(frozen=True)
class VisualConfig:
    """Static VisualSORT configuration (same fields and defaults as the
    reference's)."""

    positional_kind: str = "iou"  # "iou" | "maha"
    iou_threshold: float = 0.3
    positional_min_confidence: float = 0.1
    visual_kind: str = "euclidean"  # "euclidean" | "cosine"
    visual_threshold: float = 3.4e38
    visual_minimal_track_length: int = 3
    visual_minimal_area: float = 0.0
    visual_minimal_quality_use: float = 0.0
    visual_minimal_quality_collect: float = 0.0
    visual_min_votes: int = 1
    own_area_use: float = 0.0
    own_area_collect: float = 0.0
    own_area_backend: str = "device"  # "device" | "host"
    own_area_order: int = 3
    own_area_neighbors: int = 8
    max_idle_epochs: int = 2
    constraints: Tuple[Tuple[int, float], ...] = ()
    position_weight: float = kal.DEFAULT_POSITION_WEIGHT
    velocity_weight: float = kal.DEFAULT_VELOCITY_WEIGHT
    assignment: str = "auto"
    # gallery distance inputs: "f32" | "bf16".  Both paths multiply and sum
    # in f32.  The general step rounds features and gallery to bf16 and
    # takes the norms of the rounded values (ops/distances.py); the fused
    # kernel rounds only the product's inputs and takes the norms of the
    # f32 values.
    feature_precision: str = "f32"
    oriented: bool = True
    oriented_neighbors: int = 0
    recycle_idle: bool = False

    @property
    def new_track_threshold(self) -> float:
        return (
            self.iou_threshold
            if self.positional_kind == "iou"
            else MAHALANOBIS_NEW_TRACK_THRESHOLD
        )

    @property
    def kalman_spec(self) -> kal.KalmanSpec:
        return kal.KalmanSpec(self.position_weight, self.velocity_weight)

    @property
    def own_area_on_device(self) -> bool:
        """Whether the step computes own-area shares itself."""
        gates = self.own_area_use > 0.0 or self.own_area_collect > 0.0
        return gates and self.own_area_backend == "device"


@dataclasses.dataclass(frozen=True)
class VisualStepOutput:
    slot: torch.Tensor  # [..., D] int32
    track_id: torch.Tensor  # [..., D] int32
    is_new: torch.Tensor  # [..., D] bool
    pred_box: torch.Tensor  # [..., D, 5]
    length: torch.Tensor  # [..., D] int32
    voting_type: torch.Tensor  # [..., D] int32 (VT_VISUAL / VT_POSITIONAL)
    overflow: torch.Tensor  # [...] bool


def positional_weights(cfg: VisualConfig, state: VisualState, det_box,
                       det_conf, compat):
    """[S, D, T] positional metric and its validity."""
    conf = torch.clamp(det_conf, min=cfg.positional_min_confidence)
    if cfg.positional_kind == "iou":
        nbrs = (cfg.oriented_neighbors
                if cfg.oriented
                and state.capacity >= 4 * cfg.oriented_neighbors else 0)
        iou, valid = geo.universal_iou_matrix(
            det_box, state.pred_box, cfg.oriented, neighbors=nbrs)
        m = iou * conf[..., None]
        valid = valid & (m >= cfg.iou_threshold) & compat
        return torch.where(valid, m, 0.0), valid
    d2 = cfg.kalman_spec.distance_matrix(state.kf, det_box)
    m = kal.calculate_cost(d2, inverted=True) / conf[..., None]
    tf = geo.too_far(det_box[..., :, None, :], state.pred_box[..., None, :, :])
    valid = compat & ~tf
    return torch.where(valid, m, 0.0), valid


def _feature_gram(cfg: VisualConfig, state: VisualState, det_feat):
    """`ops/distances.py::gram` of the detections' features against the
    gallery lanes, at the configured precision."""
    q, g = det_feat, state.feats
    if cfg.feature_precision == "bf16":
        q, g = q.to(torch.bfloat16), g.to(torch.bfloat16)
    return dst.gram(q, g, cfg.visual_kind)


def _track_gate(cfg: VisualConfig, state: VisualState):
    return state.collected >= cfg.visual_minimal_track_length


def visual_votes(cfg: VisualConfig, state: VisualState, det_feat, det_gate,
                 compat):
    """(votes [S, D, T], weight [S, D, T]): the gallery lanes that pass the
    metric and the gates, and the best-fit weight sum(max_dist - d) over
    them, where max_dist is the largest passing distance of the scene."""
    dot, qn, gn = _feature_gram(cfg, state, det_feat)
    return vv.votes_and_weight(dot, qn, gn, det_gate, compat,
                               _track_gate(cfg, state), state.feat_valid,
                               cfg.visual_kind, cfg.visual_threshold)


def _first_free(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis; 0 when there is none."""
    return asg.first_argmax(mask.to(torch.int32), -1)[1]


def _visual_step_impl(cfg: VisualConfig, defer: bool, state: VisualState,
                      det_box, det_conf, det_valid, det_feat, det_feat_valid,
                      det_quality, det_own_area, epoch: torch.Tensor):
    """The step on [S, ...] tensors with epochs [S].  `defer` leaves the
    gallery-lane and feature-history writes to the caller: the state's
    `feats` and `hist_feat` come back as they went in, and the third
    result is (src [S, D, F] in the state's dtype, gallery row [S, D] of
    the [T*K] lanes, its mask, history row [S, D] of the [T*H] ring, its
    mask), else None."""
    s, d = det_box.shape[:2]
    t, k, h = state.capacity, state.gallery_size, state.history
    spec = cfg.kalman_spec
    det_valid = det_valid.bool()
    det_feat_valid = det_feat_valid.bool()

    with span("visual_step.weights"):
        if cfg.recycle_idle:
            state = dataclasses.replace(
                state, active=state.active
                & (epoch[:, None] - state.last_epoch <= cfg.max_idle_epochs))

        compat = _compat(cfg, state.active, state.last_epoch, det_box,
                         state.pred_box, epoch)
        P, p_valid = positional_weights(cfg, state, det_box, det_conf, compat)
        if cfg.own_area_on_device:
            det_own_area = owna.own_area_shares(
                det_box, det_valid, order=cfg.own_area_order,
                neighbors=cfg.own_area_neighbors)

        # candidate-side feature gates
        area_ok = geo.box_area(det_box) >= cfg.visual_minimal_area
        use_gate = (det_feat_valid & det_valid
                    & (det_quality >= cfg.visual_minimal_quality_use)
                    & (det_own_area >= cfg.own_area_use) & area_ok)
        collect_gate = (det_feat_valid
                        & (det_quality >= cfg.visual_minimal_quality_collect)
                        & (det_own_area >= cfg.own_area_collect) & area_ok)

    with span("visual_step.votes"):
        dot, qn, gn = _feature_gram(cfg, state, det_feat)

    with span("visual_step.best_fit"):
        # votes and the greedy best-fit claim in closed form, in one kernel
        # on the card (ops/visual_votes.py)
        t1, has_any, wins_visual, claimed = vv.visual_best_fit(
            dot, qn, gn, use_gate, compat, _track_gate(cfg, state),
            state.feat_valid, det_valid, cfg.visual_kind,
            cfg.visual_threshold, cfg.visual_min_votes)

    with span("visual_step.auction"):
        # positional assignment on the remainder (a candidate with any vote
        # is decided, winner or not)
        row_open = det_valid & ~has_any
        col_open = state.active & ~claimed
        P_masked = torch.where(row_open[..., None] & col_open[..., None, :]
                               & p_valid, P, 0.0)
        col = asg.solve_voting(
            P_masked, cfg.new_track_threshold, det_valid, col_open,
            asg.resolve_backend(cfg.assignment, det_box.device))
        ptgt = torch.clamp(col - d, 0, t - 1)
        pos_matched = (row_open & (col >= d)
                       & (mrg.take_at(P_masked, ptgt)
                          >= cfg.new_track_threshold))
        matched = wins_visual | pos_matched
        tgt = torch.where(wins_visual, t1, ptgt)
        vt = torch.where(wins_visual, VT_VISUAL, VT_POSITIONAL).to(torch.int32)

    with span("visual_step.slots_kalman"):
        # slot allocation
        is_new = det_valid & ~matched
        new_rank = torch.cumsum(is_new.long(), -1) - 1
        n_new = is_new.sum(-1)
        overflow = n_new > (~state.active).sum(-1)
        slot = torch.where(matched, tgt,
                           mrg.nth_free_slot(state.active, new_rank))
        safe = det_valid & ~overflow[:, None]

        # Kalman update
        kf_fields = [f.name for f in dataclasses.fields(kal.KalmanState)]
        init = spec.initiate(det_box)
        prev = kal.KalmanState(*(
            torch.where(matched[..., None],
                        mrg.take_rows(getattr(state.kf, f), slot),
                        getattr(init, f))
            for f in kf_fields))
        st = spec.update(spec.predict(prev), det_box)
        pred_box = st.mean_pos

        new_length = torch.where(matched,
                                 mrg.take_rows(state.length, slot) + 1, 1)
        new_ids = torch.where(matched, mrg.take_rows(state.track_id, slot),
                              state.next_id[:, None] + new_rank + 1).to(
                                  torch.int32)

    with span("visual_step.gallery"):
        # gallery update: evict the lowest-quality lane of a full gallery (the
        # first among equals), insert into the first free lane
        gal_valid = matched[..., None] & mrg.take_rows(state.feat_valid, slot)
        gal_q = mrg.take_rows(state.feat_quality, slot)
        lanes = torch.arange(k, device=det_box.device)
        evict_needed = gal_valid.sum(-1) >= k
        _, evict_k = asg.first_argmax(
            -torch.where(gal_valid, gal_q, float("inf")), -1)
        gal_valid = gal_valid & ~(evict_needed[..., None]
                                  & (lanes == evict_k[..., None]))
        # the first feature of a brand-new track bypasses the collect gate
        keep_new = det_feat_valid & (is_new | collect_gate)
        free_k = _first_free(~gal_valid)  # always exists after eviction
        new_lane = (lanes == free_k[..., None]) & keep_new[..., None]
        final_valid = gal_valid | new_lane
        final_q = torch.where(new_lane, det_quality[..., None], gal_q)
        collected = final_valid.sum(-1).to(torch.int32)

    with span("visual_step.state_write"):
        hix = (new_length - 1) % h
        index = mrg.write_index(slot, safe, t)
        written = mrg.written(index, t)

        if defer:
            feats, hist_feat = state.feats, state.hist_feat
            slot_i = torch.clamp(slot, 0, t - 1)
            fmerge = (det_feat.to(state.feats.dtype),
                      (slot_i * k + free_k).to(torch.int32),
                      (safe & keep_new).to(torch.int32),
                      (slot_i * h + hix).to(torch.int32),
                      safe.to(torch.int32))
        else:
            # gallery lanes take the tighter collect mask, so a skipped feature
            # leaves its lane untouched
            feats = mrg.merge_lane(state.feats, det_feat, free_k,
                                   mrg.write_index(slot, safe & keep_new, t))
            hist_feat = mrg.merge_ring(state.hist_feat, det_feat, hix, index)
            fmerge = None

        new_state = VisualState(
            kf=kal.KalmanState(*(
                mrg.merge_rows(getattr(state.kf, f), getattr(st, f), index)
                for f in kf_fields)),
            pred_box=mrg.merge_rows(state.pred_box, pred_box, index),
            obs_box=mrg.merge_rows(state.obs_box, det_box, index),
            conf=mrg.merge_rows(state.conf, det_conf, index),
            active=state.active | written,
            last_epoch=torch.where(written, epoch[:, None],
                                   state.last_epoch).to(torch.int32),
            length=mrg.merge_rows(state.length, new_length, index),
            track_id=mrg.merge_rows(state.track_id, new_ids, index),
            hist_obs=mrg.merge_ring(state.hist_obs, det_box, hix, index),
            hist_pred=mrg.merge_ring(state.hist_pred, pred_box, hix, index),
            hist_conf=mrg.merge_ring(state.hist_conf, det_conf, hix, index),
            next_id=(state.next_id + n_new).to(torch.int32),
            feats=feats,
            feat_quality=mrg.merge_rows(state.feat_quality, final_q, index),
            feat_valid=mrg.merge_rows(state.feat_valid, final_valid, index),
            collected=mrg.merge_rows(state.collected, collected, index),
            voting_type=mrg.merge_rows(state.voting_type, vt, index),
            hist_feat=hist_feat,
            hist_feat_valid=mrg.merge_ring(state.hist_feat_valid,
                                           det_feat_valid, hix, index),
        )
        out = VisualStepOutput(
            slot=slot.to(torch.int32), track_id=new_ids, is_new=is_new,
            pred_box=pred_box, length=new_length.to(torch.int32),
            voting_type=vt, overflow=overflow)
    return new_state, out, fmerge


def _check_config(cfg: VisualConfig) -> None:
    if cfg.positional_kind not in ("iou", "maha"):
        raise ValueError(f"positional_kind {cfg.positional_kind!r}")
    if cfg.visual_kind not in ("euclidean", "cosine"):
        raise ValueError(f"visual_kind {cfg.visual_kind!r}")
    if cfg.feature_precision not in ("f32", "bf16"):
        raise ValueError(f"feature_precision {cfg.feature_precision!r}")
    if cfg.own_area_backend not in ("device", "host"):
        raise ValueError(f"own_area_backend {cfg.own_area_backend!r}")


def _step(cfg, defer, state, det_box, det_conf, det_valid, det_feat,
          det_feat_valid, det_quality, det_own_area, epoch):
    """Single-scene inputs run as the S = 1 case; outputs lose the axis."""
    _check_config(cfg)
    args = (det_box, det_conf, det_valid, det_feat, det_feat_valid,
            det_quality, det_own_area)
    if det_box.dim() == 3:
        return _visual_step_impl(
            cfg, defer, state, *args,
            scene_epochs(epoch, det_box.shape[0], state.device))
    st, out, fmerge = _visual_step_impl(
        cfg, defer, map_tensors(lambda a: a[None], state),
        *(a[None] for a in args), scene_epochs(epoch, 1, state.device))
    return (map_tensors(lambda a: a[0], st), map_tensors(lambda a: a[0], out),
            None if fmerge is None else tuple(x[0] for x in fmerge))


def visual_step(cfg: VisualConfig, state: VisualState,
                det_box: torch.Tensor,  # [S?, D, 5]
                det_conf: torch.Tensor,  # [S?, D]
                det_valid: torch.Tensor,  # [S?, D] bool
                det_feat: torch.Tensor,  # [S?, D, F]
                det_feat_valid: torch.Tensor,  # [S?, D] bool
                det_quality: torch.Tensor,  # [S?, D]
                det_own_area: torch.Tensor,  # [S?, D] (1.0 when gating is off)
                epoch,  # int, or int[S] per scene
                ) -> Tuple[VisualState, VisualStepOutput]:
    """One frame of the general step; with the scene axis the state
    carries it too."""
    new_state, out, _ = _step(cfg, False, state, det_box, det_conf,
                              det_valid, det_feat, det_feat_valid,
                              det_quality, det_own_area, epoch)
    return new_state, out


def visual_step_deferred(cfg: VisualConfig, state: VisualState, *args):
    """`visual_step` with the two big feature writes (gallery lanes and
    feature-history ring) returned instead of applied: (state, out,
    fmerge) with fmerge = (src, rowf, maskf, rowh, maskh), rows into the
    flattened [T*K] lanes and [T*H] ring of each scene.  The returned
    state shares the input's `feats` and `hist_feat` tensors unchanged;
    `parallel/mesh.py::batched_visual_step_inplace` writes them in place
    with the merge kernel (`ops/merge_inplace.py`)."""
    return _step(cfg, True, state, *args)


def visual_scan(cfg: VisualConfig, state: VisualState, det_box, det_conf,
                det_valid, det_feat, det_feat_valid, det_quality,
                det_own_area, epoch0: Union[int, np.ndarray, torch.Tensor]
                ) -> Tuple[VisualState, VisualStepOutput]:
    """`visual_step` over a frame stream [N, D, ...] of one scene; outputs
    are stacked [N, D, ...].  `epoch0` is the first epoch of consecutive
    frames, or the N per-frame epochs (gaps age tracks)."""
    steps = det_box.shape[0]
    if isinstance(epoch0, (torch.Tensor, np.ndarray)) and np.ndim(epoch0):
        epochs = [int(e) for e in epoch0.tolist()]
        if len(epochs) != steps:
            raise ValueError(f"{len(epochs)} epochs for {steps} frames")
    else:
        epochs = [int(epoch0) + i for i in range(steps)]
    outs = []
    for i, e in enumerate(epochs):
        state, out = visual_step(
            cfg, state, det_box[i], det_conf[i], det_valid[i], det_feat[i],
            det_feat_valid[i], det_quality[i], det_own_area[i], e)
        outs.append(out)
    return state, VisualStepOutput(*(
        torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(VisualStepOutput)))
