"""SoA state for the VisualSORT tracker (mirrors
`similari_tpu/trackers/visual_state.py`): the SORT columns plus a fixed-K
ReID gallery per track, kept as (feats, quality, valid) lanes with
quality-sorted eviction.  A batch of scenes carries a leading scene axis on
every tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike, resolve_device
from ..ops.kalman import KalmanState, empty_state
from .state import grow_state


@dataclasses.dataclass(frozen=True)
class VisualState:
    # --- SORT columns (see state.SortState) ---
    kf: KalmanState
    pred_box: torch.Tensor  # [T, 5]
    obs_box: torch.Tensor  # [T, 5]
    conf: torch.Tensor  # [T]
    active: torch.Tensor  # [T] bool
    last_epoch: torch.Tensor  # [T] int32
    length: torch.Tensor  # [T] int32
    track_id: torch.Tensor  # [T] int32
    hist_obs: torch.Tensor  # [T, H, 5]
    hist_pred: torch.Tensor  # [T, H, 5]
    hist_conf: torch.Tensor  # [T, H]
    next_id: torch.Tensor  # scalar int32
    # --- visual columns ---
    feats: torch.Tensor  # [T, K, F] gallery features
    feat_quality: torch.Tensor  # [T, K]
    feat_valid: torch.Tensor  # [T, K] bool
    collected: torch.Tensor  # [T] int32
    voting_type: torch.Tensor  # [T] int32 (0=Visual, 1=Positional; -1=None)
    hist_feat: torch.Tensor  # [T, H, F]
    hist_feat_valid: torch.Tensor  # [T, H] bool

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def history(self) -> int:
        return self.hist_obs.shape[-2]

    @property
    def gallery_size(self) -> int:
        return self.feats.shape[-2]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.active.device


def new_visual_state(capacity: int, history: int, gallery: int,
                     feature_dim: int, feature_dtype=torch.float32,
                     device: DeviceLike = None) -> VisualState:
    """feature_dtype: storage dtype of the gallery and feature history."""
    dev = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return VisualState(
        kf=empty_state(capacity, 5, dev),
        pred_box=z(capacity, 5),
        obs_box=z(capacity, 5),
        conf=z(capacity),
        active=z(capacity, dtype=torch.bool),
        last_epoch=z(capacity, dtype=torch.int32),
        length=z(capacity, dtype=torch.int32),
        track_id=z(capacity, dtype=torch.int32),
        hist_obs=z(capacity, history, 5),
        hist_pred=z(capacity, history, 5),
        hist_conf=z(capacity, history),
        next_id=torch.tensor(0, dtype=torch.int32, device=dev),
        feats=z(capacity, gallery, feature_dim, dtype=feature_dtype),
        feat_quality=z(capacity, gallery),
        feat_valid=z(capacity, gallery, dtype=torch.bool),
        collected=z(capacity, dtype=torch.int32),
        voting_type=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        hist_feat=z(capacity, history, feature_dim, dtype=feature_dtype),
        hist_feat_valid=z(capacity, history, dtype=torch.bool),
    )


def grow_visual_state(state: VisualState, new_capacity: int) -> VisualState:
    """`state.grow_state` for the visual store: the new slots also take the
    `voting_type` sentinel -1; the gallery and feature history keep their
    dtype (bf16 stays bf16)."""
    t = state.capacity
    out = grow_state(state, new_capacity)
    out.voting_type[..., t:] = -1  # a new tensor: nothing else holds it
    return out
