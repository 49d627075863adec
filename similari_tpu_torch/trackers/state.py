"""SoA track-store state for the SORT tracker (mirrors
`similari_tpu/trackers/state.py`).

A fixed-capacity struct of tensors per scene: slots are recycled through
the `active` mask, and the fused kernels read and write it by slot index.
A batch of scenes is the same struct with a leading scene axis on every
tensor (`next_id` becomes [S]).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike, resolve_device
from ..ops.kalman import KalmanState, empty_state


@dataclasses.dataclass(frozen=True)
class SortState:
    """Per-scene track store: capacity T, history depth H."""

    kf: KalmanState  # [T, 5] components
    pred_box: torch.Tensor  # [T, 5] last KF-updated box
    obs_box: torch.Tensor  # [T, 5] last observed box
    conf: torch.Tensor  # [T] confidence of the last observation
    active: torch.Tensor  # [T] bool
    last_epoch: torch.Tensor  # [T] int32
    length: torch.Tensor  # [T] int32
    track_id: torch.Tensor  # [T] int32 (sequential from 1)
    hist_obs: torch.Tensor  # [T, H, 5]
    hist_pred: torch.Tensor  # [T, H, 5]
    hist_conf: torch.Tensor  # [T, H]
    next_id: torch.Tensor  # scalar int32: number of ids issued so far

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def history(self) -> int:
        return self.hist_obs.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.active.device


def map_tensors(fn, obj):
    """The dataclass `obj` (a state, its Kalman state, a step output) with
    `fn` applied to every tensor, nested dataclasses included."""
    return type(obj)(**{
        f.name: (map_tensors(fn, v) if dataclasses.is_dataclass(v) else fn(v))
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})


def new_sort_state(capacity: int, history: int, next_id: int = 0,
                   device: DeviceLike = None) -> SortState:
    dev = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SortState(
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
        next_id=torch.tensor(next_id, dtype=torch.int32, device=dev),
    )


def pad_rows(a: torch.Tensor, rows: int, axis: int = 0) -> torch.Tensor:
    """`a` with `rows` rows of zeros appended on `axis`, on its device and
    in its dtype; a tensor without that axis (`next_id`) comes back as it
    is."""
    if a.dim() <= axis:
        return a
    shape = list(a.shape)
    shape[axis] = rows
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def grow_state(state: SortState, new_capacity: int) -> SortState:
    """The store at `new_capacity` slots (the slot axis follows a leading
    scene axis when the state has one): the new slots are zero, so
    inactive.  The Sort API doubles capacity before a step that could
    overflow it."""
    t = state.capacity
    assert new_capacity > t
    axis = state.active.dim() - 1
    return map_tensors(lambda a: pad_rows(a, new_capacity - t, axis), state)
