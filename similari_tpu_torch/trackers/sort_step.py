"""The general SORT step and its scan (mirrors
`similari_tpu/trackers/sort_step.py`).

    (state, padded detections, epoch) -> (state', per-detection outputs)

One step: the voting weights of every (detection, track) pair (aligned or
oriented IoU x confidence, or inverted Mahalanobis cost / confidence, with
the idle gate, the `too_far` prune and spatio-temporal constraints), the
assignment on the augmented [D, D+T] voting matrix (new-track threshold on
the diagonal), free-slot allocation in slot order, one masked Kalman
predict/update for matched and new rows, and the state write (dropped for
padded rows and for every row of an overflowing frame), with histories of
depth H in ring buffers.

`sort_step` takes an optional leading scene axis: a state whose tensors
carry [S, ...], detections [S, D, ...] and per-scene epochs int[S] run S
independent scenes in one pass of the same tensor code, with every
reduction (auction eps, new-track count, overflow, next id, free-slot
ranks) per scene.  The single-scene call is the S = 1 case.

Oriented IoU matching at T >= 512 and D >= 64 can take the sorted path
(`_match_sorted`): per scene, x-sorted views of both axes, the rotated
IoU of every scene from one launch of the tile-skipping clip kernel
(`ops/clip.py`), the auction in sorted space.
`oriented_block_sort="auto"` takes it when the state is on CUDA; True
forces it on any device (on the CPU the clip's plain version runs); False
keeps the dense path.  It runs with or without the scene axis, so the
batched steps (`parallel/mesh.py`) take it as configured.  The fused
kernel (`ops/fused_sort.py`) covers the aligned-IoU case of the same step
for whole frame chunks.

The step's stages are spans of `utils/profiling.py`: `sort_step.weights`,
`sort_step.auction`, `sort_step.slots_kalman`, `sort_step.state_write`;
the sorted path's weights hold `sort_step.sort_scenes` (the sorts and
gathers) and `sort_step.clip` (the launch), and `sort_step.unsort`
scatters its results back after the auction.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from ..ops import assignment as asg
from ..ops import clip
from ..ops import geometry as geo
from ..ops import kalman as kal
from ..ops import merge as mrg
from .constraints import allowed_distance_for_delta
from .state import SortState, map_tensors
from ..utils.profiling import span, wait

MAHALANOBIS_NEW_TRACK_THRESHOLD = 1.0
DEFAULT_SORT_IOU_THRESHOLD = 0.3
DEFAULT_MINIMAL_SORT_CONFIDENCE = 0.05
SORTED_MIN_TRACKS = 512  # the sorted path's gate: T >= 512 and D >= 64
SORTED_MIN_DETECTIONS = 64
_BIG = 3.0e38  # sort key of inactive slots and padded rows: they sort last


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Static tracker configuration (same fields and defaults as the
    reference's)."""

    method: str = "maha"  # "iou" | "maha"
    iou_threshold: float = DEFAULT_SORT_IOU_THRESHOLD
    min_confidence: float = DEFAULT_MINIMAL_SORT_CONFIDENCE
    max_idle_epochs: int = 5
    constraints: Tuple[Tuple[int, float], ...] = ()
    position_weight: float = kal.DEFAULT_POSITION_WEIGHT
    velocity_weight: float = kal.DEFAULT_VELOCITY_WEIGHT
    # "auto": the auction on CUDA, scipy's Hungarian on the CPU
    assignment: str = "auto"  # "auto" | "auction" | "hungarian" | "native"
    # static flag: False uses the exact axis-aligned IoU
    oriented: bool = True
    # > 0: the oriented IoU clips only each detection's k nearest in-radius
    # tracks (geometry.rotated_intersection_topk) when capacity >= 4k; the
    # sorted path, where it applies, comes first
    oriented_neighbors: int = 0
    # retire tracks idle past max_idle_epochs at the top of every step so
    # the static capacity bounds live tracks
    recycle_idle: bool = False
    # "auto" | True | False: the sorted clip-kernel path (see module doc)
    oriented_block_sort: object = "auto"

    @property
    def new_track_threshold(self) -> float:
        return (
            self.iou_threshold
            if self.method == "iou"
            else MAHALANOBIS_NEW_TRACK_THRESHOLD
        )

    @property
    def kalman_spec(self) -> kal.KalmanSpec:
        return kal.KalmanSpec(self.position_weight, self.velocity_weight)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    slot: torch.Tensor  # [S?, D] int32 store slot per detection
    track_id: torch.Tensor  # [S?, D] int32
    is_new: torch.Tensor  # [S?, D] bool (new track vs merged)
    pred_box: torch.Tensor  # [S?, D, 5]
    length: torch.Tensor  # [S?, D] int32
    overflow: torch.Tensor  # [S?] bool: ran out of free slots


def scene_epochs(epoch, scenes: int, device: torch.device) -> torch.Tensor:
    """The epoch of each of `scenes` scenes as an int tensor [S]: a scalar
    is shared, a sequence or tensor gives one per scene.  An epoch from
    the host copied to the card waits for the card's stream."""
    if device.type == "cpu" or (isinstance(epoch, torch.Tensor)
                                and epoch.device == device):
        e = torch.as_tensor(epoch, device=device)
    else:
        with wait("sort_step.epochs"):
            e = torch.as_tensor(epoch, device=device)
    return e.expand(scenes) if e.dim() == 0 else e


def _compat(cfg: SortConfig, active, last_epoch, det_box, pred_box, epoch):
    """[S?, D, T] bool: tracks a detection may match (active, idle at most
    max_idle_epochs, within the constraint for its epoch delta)."""
    delta = epoch[..., None] - last_epoch
    compat = active & (delta <= cfg.max_idle_epochs)
    if cfg.constraints:
        d2r = geo.dist_in_2r(det_box[..., :, None, :],
                             pred_box[..., None, :, :])
        allowed = allowed_distance_for_delta(cfg.constraints, delta)
        return compat[..., None, :] & (d2r <= allowed[..., None, :])
    return compat[..., None, :].expand(*det_box.shape[:-1],
                                       active.shape[-1])


def distance_weights(cfg: SortConfig, state: SortState, det_box: torch.Tensor,
                     det_conf: torch.Tensor, epoch) -> torch.Tensor:
    """The [S?, D, T] voting weights (0 = no edge)."""
    compat = _compat(cfg, state.active, state.last_epoch, det_box,
                     state.pred_box, epoch)
    conf = torch.clamp(det_conf, min=cfg.min_confidence)
    if cfg.method == "iou":
        nbrs = (cfg.oriented_neighbors
                if cfg.oriented and state.capacity >= 4 * cfg.oriented_neighbors
                else 0)
        iou, valid = geo.universal_iou_matrix(
            det_box, state.pred_box, cfg.oriented, neighbors=nbrs)
        m = iou * conf[..., :, None]
        valid = valid & (m >= cfg.iou_threshold)
        return torch.where(compat & valid, m, 0.0)
    d2 = cfg.kalman_spec.distance_matrix(state.kf, det_box)
    cost = kal.calculate_cost(d2, inverted=True)
    m = cost / conf[..., :, None]
    tf = geo.too_far(det_box[..., :, None, :], state.pred_box[..., None, :, :])
    return torch.where(compat & ~tf, m, 0.0)


def _assign(cfg, W, det_valid, active):
    """(matched [S?, D], target column [S?, D]) from the voting weights; a
    match must also carry at least the threshold (absorbs auction slop)."""
    d, t = W.shape[-2:]
    col = asg.solve_voting(W, cfg.new_track_threshold, det_valid, active,
                           asg.resolve_backend(cfg.assignment, W.device))
    tgt = torch.clamp(col - d, 0, t - 1)
    pair_w = mrg.take_at(W, tgt)
    return det_valid & (col >= d) & (pair_w >= cfg.new_track_threshold), tgt


def _match_plain(cfg, state, det_box, det_conf, det_valid, epoch):
    with span("sort_step.weights"):
        W = distance_weights(cfg, state, det_box, det_conf, epoch)
    with span("sort_step.auction"):
        return _assign(cfg, W, det_valid, state.active)


def _match_sorted(cfg, state, det_box, det_conf, det_valid, epoch):
    """Oriented-IoU matching on x-sorted views of both axes, scene by
    scene, on [S, ...] tensors with epochs [S].

    One stable sort along the slot axis and one along the row axis
    (inactive slots and padded rows last) put each scene's boxes in order
    of x, which gathers its in-radius pairs near its diagonal, so the clip
    kernel skips most of its tiles.  The auction runs on [S, D, T] in
    sorted space; only the [S, D] results go back.  Each scene's answer is
    that of the call on the scene alone (S = 1), and the same LP as
    `_match_plain` up to near-tie resolution.
    """
    with span("sort_step.weights"):
        with span("sort_step.sort_scenes"):
            tkey = torch.where(state.active, state.pred_box[..., 0], _BIG)
            tperm = torch.sort(tkey, dim=-1, stable=True).indices
            pred_s = mrg.take_rows(state.pred_box, tperm)
            act_s = state.active.gather(-1, tperm)
            last_s = state.last_epoch.gather(-1, tperm)
            dkey = torch.where(det_valid, det_box[..., 0], _BIG)
            dperm = torch.sort(dkey, dim=-1, stable=True).indices
            det_s = mrg.take_rows(det_box, dperm)
            dval_s = det_valid.gather(-1, dperm)
            conf_s = det_conf.gather(-1, dperm)
        compat = _compat(cfg, act_s, last_s, det_s, pred_s, epoch)
        conf = torch.clamp(conf_s, min=cfg.min_confidence)
        with span("sort_step.clip"):
            iou, valid = clip.oriented_iou_blockskip(det_s, pred_s)
        m = iou * conf[..., :, None]
        valid = valid & (m >= cfg.iou_threshold)
        W = torch.where(compat & valid, m, 0.0)
    with span("sort_step.auction"):
        matched_s, tgt_s = _assign(cfg, W, dval_s, act_s)
    with span("sort_step.unsort"):
        matched = torch.empty_like(matched_s).scatter_(-1, dperm, matched_s)
        tgt = torch.empty_like(tgt_s).scatter_(-1, dperm,
                                               tperm.gather(-1, tgt_s))
    return matched, tgt


def use_sorted_path(cfg: SortConfig, d: int, t: int,
                    device: torch.device) -> bool:
    """Whether `sort_step` matches on the sorted clip-kernel path."""
    block_sort = (cfg.oriented_block_sort is True
                  or (cfg.oriented_block_sort == "auto"
                      and device.type == "cuda"))
    return (cfg.method == "iou" and cfg.oriented and block_sort
            and t >= SORTED_MIN_TRACKS and d >= SORTED_MIN_DETECTIONS)


def sort_step(cfg: SortConfig, state: SortState, det_box: torch.Tensor,
              det_conf: torch.Tensor, det_valid: torch.Tensor,
              epoch) -> Tuple[SortState, StepOutput]:
    """One frame: det_box f32[S?, D, 5], det_conf f32[S?, D], det_valid
    bool[S?, D] at `epoch` (an int, or int[S] per scene).  With the scene
    axis the state carries it too.  Returns the new state and the
    per-detection outputs."""
    if det_box.dim() == 2:
        st, out = _sort_step(
            cfg, map_tensors(lambda a: a[None], state), det_box[None],
            det_conf[None], det_valid[None],
            scene_epochs(epoch, 1, state.device))
        return (map_tensors(lambda a: a[0], st),
                map_tensors(lambda a: a[0], out))
    return _sort_step(cfg, state, det_box, det_conf, det_valid,
                      scene_epochs(epoch, det_box.shape[0], state.device))


def _sort_step(cfg: SortConfig, state: SortState, det_box, det_conf,
               det_valid, epoch: torch.Tensor):
    """`sort_step` on [S, ...] tensors with epochs [S]."""
    d = det_box.shape[1]
    t = state.capacity
    spec = cfg.kalman_spec
    det_valid = det_valid.bool()

    if cfg.recycle_idle:
        # idle-beyond-max tracks are already incompatible, so matching is
        # unchanged; only slot reuse differs
        state = dataclasses.replace(
            state, active=state.active
            & (epoch[:, None] - state.last_epoch <= cfg.max_idle_epochs))

    match = (_match_sorted if use_sorted_path(cfg, d, t, state.device)
             else _match_plain)
    matched, tgt = match(cfg, state, det_box, det_conf, det_valid, epoch)

    with span("sort_step.slots_kalman"):
        # slot allocation: the r-th new detection takes the r-th free slot
        is_new = det_valid & ~matched
        new_rank = torch.cumsum(is_new.long(), -1) - 1
        n_new = is_new.sum(-1)
        n_free = (~state.active).sum(-1)
        overflow = n_new > n_free
        slot = torch.where(matched, tgt,
                           mrg.nth_free_slot(state.active, new_rank))
        safe = det_valid & ~overflow[:, None]

        # one masked Kalman step for matched and new rows
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

    with span("sort_step.state_write"):
        # state write: unsafe rows go to their scene's scratch row
        index = mrg.write_index(slot, safe, t)
        written = mrg.written(index, t)
        hix = (new_length - 1) % state.history
        new_state = SortState(
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
        )
        out = StepOutput(
            slot=slot.to(torch.int32),
            track_id=new_ids,
            is_new=is_new,
            pred_box=pred_box,
            length=new_length.to(torch.int32),
            overflow=overflow,
        )
    return new_state, out


def sort_scan(cfg: SortConfig, state: SortState, det_box: torch.Tensor,
              det_conf: torch.Tensor, det_valid: torch.Tensor,
              epoch0: Union[int, np.ndarray, torch.Tensor]
              ) -> Tuple[SortState, StepOutput]:
    """`sort_step` over S frames (det_box [S, D, 5], det_conf and det_valid
    [S, D]); outputs are stacked [S, D, ...].

    `epoch0` is the first epoch of consecutive frames, or the S per-frame
    epochs (for example the frame numbers), so gaps between frames age
    tracks as stepping every frame would.
    """
    steps = det_box.shape[0]
    if isinstance(epoch0, (torch.Tensor, np.ndarray)) and np.ndim(epoch0):
        epochs = [int(e) for e in epoch0.tolist()]
        if len(epochs) != steps:
            raise ValueError(f"{len(epochs)} epochs for {steps} frames")
    else:
        epochs = [int(epoch0) + s for s in range(steps)]
    outs = []
    for s, e in enumerate(epochs):
        state, out = sort_step(cfg, state, det_box[s], det_conf[s],
                               det_valid[s], e)
        outs.append(out)
    stacked = StepOutput(*(
        torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(StepOutput)))
    return state, stacked
