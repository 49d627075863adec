"""Tracker state carried across as a dict of numpy arrays.

The dict is keyed by the state dataclass field names (the same names the
JAX package uses), with `kf` a nested dict of `mean_pos`, `mean_vel`,
`cpp`, `cpv` and `cvv`.  `next_id` is a 0-d array.  Dtypes are kept as
given, except that bfloat16 tensors leave as float32 (numpy has no
bfloat16) and come back as float32, or as `feature_dtype` for the gallery
and feature history.  A batch of scenes crosses the same way, with the
leading scene axis on every array (`next_id` [S]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.kalman import KalmanState
from .trackers.state import SortState
from .trackers.visual_state import VisualState

_KF = ("mean_pos", "mean_vel", "cpp", "cpv", "cvv")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _state_to_numpy(state) -> Dict:
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "kf":
            out["kf"] = {k: _to_numpy(getattr(v, k)) for k in _KF}
        else:
            out[f.name] = _to_numpy(v)
    return out


def _state_from_numpy(cls, d: Dict, device: DeviceLike, feature_dtype=None):
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "kf":
            kw["kf"] = KalmanState(*(
                torch.from_numpy(np.array(d["kf"][k], np.float32)).to(dev)
                for k in _KF))
            continue
        kw[f.name] = torch.from_numpy(np.array(d[f.name])).to(dev)
        if feature_dtype is not None and f.name in ("feats", "hist_feat"):
            kw[f.name] = kw[f.name].to(feature_dtype)
    return cls(**kw)


def sort_state_to_numpy(state: SortState) -> Dict:
    return _state_to_numpy(state)


def sort_state_from_numpy(d: Dict, device: DeviceLike = None) -> SortState:
    return _state_from_numpy(SortState, d, device)


def visual_state_to_numpy(state: VisualState) -> Dict:
    return _state_to_numpy(state)


def visual_state_from_numpy(d: Dict, device: DeviceLike = None,
                            feature_dtype=None) -> VisualState:
    """`feature_dtype` (for example torch.bfloat16) sets the storage type
    of the gallery and feature history; by default they keep the arrays'
    type."""
    return _state_from_numpy(VisualState, d, device, feature_dtype)
