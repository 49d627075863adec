"""Batched block-diagonal Kalman filter for 2D boxes (mirrors
`similari_tpu/ops/kalman.py`).

The constant-velocity box filter only couples component i with its own
velocity, so the covariance is held as 2x2 blocks (cpp, cpv, cvv) per
component and the innovation covariance S is diagonal: every step is
elementwise arithmetic over `[..., 5]` tensors.  Components are
(xc, yc, angle, aspect, height); the aspect component (index 3) uses the
constant noise std instead of the height-scaled one.

Each expression keeps the reference's operation order (`k * weight` folded
in double first, then one f32 multiply by the height), so the CUDA kernels,
compiled without FMA contraction, reproduce these values bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device

# chi2inv(0.95, dof) table and gating bound
CHI2INV95 = (3.8415, 5.9915, 7.8147, 9.4877, 11.070, 12.592, 14.067, 15.507, 16.919)
CHI2_UPPER_BOUND = 100.0

DEFAULT_POSITION_WEIGHT = 1.0 / 20.0
DEFAULT_VELOCITY_WEIGHT = 1.0 / 160.0


@dataclasses.dataclass(frozen=True)
class KalmanState:
    """Decomposed Kalman state; tensors share a batch prefix `[..., 5]`."""

    mean_pos: torch.Tensor
    mean_vel: torch.Tensor
    cpp: torch.Tensor
    cpv: torch.Tensor
    cvv: torch.Tensor


def box_var(k: float, cnst: float, h: torch.Tensor, weight: float) -> torch.Tensor:
    """Squared stds `[w*k*h, w*k*h, w*k*h, cnst, w*k*h]` per row of h."""
    s = (k * weight) * h
    out = torch.stack([s, s, s, torch.full_like(s, cnst), s], dim=-1)
    return out * out


@dataclasses.dataclass(frozen=True)
class KalmanSpec:
    """Box filter noise configuration."""

    position_weight: float = DEFAULT_POSITION_WEIGHT
    velocity_weight: float = DEFAULT_VELOCITY_WEIGHT

    def initiate(self, z: torch.Tensor) -> KalmanState:
        """First-observation state for boxes z[..., 5]."""
        h = z[..., 4]
        zero = torch.zeros_like(z)
        return KalmanState(
            mean_pos=z, mean_vel=zero,
            cpp=box_var(2.0, 1e-2, h, self.position_weight), cpv=zero,
            cvv=box_var(10.0, 1e-5, h, self.velocity_weight))

    def predict(self, s: KalmanState) -> KalmanState:
        """Constant-velocity motion step; noise scales with the pre-motion
        height."""
        h = s.mean_pos[..., 4]
        qp = box_var(1.0, 1e-2, h, self.position_weight)
        qv = box_var(1.0, 1e-5, h, self.velocity_weight)
        return KalmanState(
            mean_pos=s.mean_pos + s.mean_vel,
            mean_vel=s.mean_vel,
            cpp=s.cpp + 2.0 * s.cpv + s.cvv + qp,
            cpv=s.cpv + s.cvv,
            cvv=s.cvv + qv,
        )

    def project(self, s: KalmanState, s_floor: Optional[float] = None):
        """(projected mean, diagonal S).  `s_floor` clamps S from below (the
        fused kernels' guard for degenerate rows)."""
        S = s.cpp + box_var(1.0, 1e-1, s.mean_pos[..., 4], self.position_weight)
        if s_floor is not None:
            S = torch.clamp(S, min=s_floor)
        return s.mean_pos, S

    def update(self, s: KalmanState, z: torch.Tensor,
               s_floor: Optional[float] = None) -> KalmanState:
        """Measurement update; S is diagonal, so the gain is a division."""
        mean_proj, S = self.project(s, s_floor)
        nu = z - mean_proj
        gp = s.cpp / S
        gv = s.cpv / S
        return KalmanState(
            mean_pos=s.mean_pos + nu * gp,
            mean_vel=s.mean_vel + nu * gv,
            cpp=s.cpp - s.cpp * gp,
            cpv=s.cpv - s.cpp * gv,
            cvv=s.cvv - s.cpv * gv,
        )

    def distance_matrix(self, s: KalmanState, z: torch.Tensor,
                        s_floor: Optional[float] = None) -> torch.Tensor:
        """Squared Mahalanobis distance, states [..., T, 5] x boxes
        [..., D, 5] -> [..., D, T], summed component by component in index
        order; leading dims (a scene axis) broadcast."""
        mean_proj, S = self.project(s, s_floor)
        d2 = torch.zeros(z.shape[:-1] + mean_proj.shape[-2:-1],
                         dtype=z.dtype, device=z.device)
        for k in range(5):
            nu = z[..., :, k:k + 1] - mean_proj[..., None, :, k]
            d2 = d2 + nu * nu / S[..., None, :, k]
        return d2


def calculate_cost(distance: torch.Tensor, inverted: bool,
                   gate: float = CHI2INV95[4]) -> torch.Tensor:
    """Chi-square gating cost.  Plain: distance, clipped to the upper bound
    above the gate; inverted: upper bound - distance, 0 above the gate."""
    over = distance > gate
    if not inverted:
        return torch.where(over, torch.full_like(distance, CHI2_UPPER_BOUND),
                           distance)
    return torch.where(over, torch.zeros_like(distance),
                       CHI2_UPPER_BOUND - distance)


def empty_state(n: int, dim: int = 5, device: DeviceLike = None) -> KalmanState:
    """Zero state for n rows; `device=None` means CUDA, as everywhere in
    the port."""
    dev = resolve_device(device)
    return KalmanState(*(torch.zeros(n, dim, dtype=torch.float32, device=dev)
                         for _ in range(5)))
