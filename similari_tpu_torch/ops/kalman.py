"""Batched block-diagonal Kalman filters for 2D boxes and 2D points
(mirrors `similari_tpu/ops/kalman.py`).

The constant-velocity filter only couples component i with its own
velocity, so the covariance is held as 2x2 blocks (cpp, cpv, cvv) per
component and the innovation covariance S is diagonal: every step is
elementwise arithmetic over `[..., K]` tensors on any device.  Box
components (K = 5) are (xc, yc, angle, aspect, height); the aspect
component (index 3) uses the constant noise std instead of the
height-scaled one.  Points (K = 2, `KalmanSpec(kind="point")`) are (x, y)
with constant stds (`kalman_2d_point.rs:41-49`).

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
    """Decomposed Kalman state; tensors share a batch prefix `[..., K]`."""

    mean_pos: torch.Tensor
    mean_vel: torch.Tensor
    cpp: torch.Tensor
    cpv: torch.Tensor
    cvv: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean_pos.shape[-1]

    def dense_covariance(self) -> torch.Tensor:
        """The full [..., 2K, 2K] covariance (introspection only)."""
        k = self.dim
        cov = self.mean_pos.new_zeros(
            self.mean_pos.shape[:-1] + (2 * k, 2 * k))
        idx = torch.arange(k, device=cov.device)
        cov[..., idx, idx] = self.cpp
        cov[..., idx, k + idx] = self.cpv
        cov[..., k + idx, idx] = self.cpv
        cov[..., k + idx, k + idx] = self.cvv
        return cov

    def mean(self) -> torch.Tensor:
        return torch.cat([self.mean_pos, self.mean_vel], dim=-1)


def box_var(k: float, cnst: float, h: torch.Tensor, weight: float) -> torch.Tensor:
    """Squared stds `[w*k*h, w*k*h, w*k*h, cnst, w*k*h]` per row of h."""
    s = (k * weight) * h
    out = torch.stack([s, s, s, torch.full_like(s, cnst), s], dim=-1)
    return out * out


def point_var(k: float, weight: float, m: torch.Tensor) -> torch.Tensor:
    """Squared stds `w*k` (rounded to f32 once) in the shape of the point
    means m[..., 2]."""
    s = torch.full_like(m, k * weight)
    return s * s


@dataclasses.dataclass(frozen=True)
class KalmanSpec:
    """Filter noise configuration, box (K = 5) or point (K = 2) flavour."""

    position_weight: float = DEFAULT_POSITION_WEIGHT
    velocity_weight: float = DEFAULT_VELOCITY_WEIGHT
    kind: str = "box"  # "box" | "point"

    def _var(self, k: float, cnst: float, m: torch.Tensor,
             weight: float) -> torch.Tensor:
        """Squared noise stds for means m[..., K]: height-scaled for boxes,
        constant for points."""
        if self.kind == "box":
            return box_var(k, cnst, m[..., 4], weight)
        return point_var(k, weight, m)

    def initiate(self, z: torch.Tensor) -> KalmanState:
        """First-observation state for z[..., K]; boxes are (xc, yc,
        angle-or-0, aspect, height)."""
        zero = torch.zeros_like(z)
        return KalmanState(
            mean_pos=z, mean_vel=zero,
            cpp=self._var(2.0, 1e-2, z, self.position_weight), cpv=zero,
            cvv=self._var(10.0, 1e-5, z, self.velocity_weight))

    def predict(self, s: KalmanState) -> KalmanState:
        """Constant-velocity motion step; box noise scales with the
        pre-motion height."""
        qp = self._var(1.0, 1e-2, s.mean_pos, self.position_weight)
        qv = self._var(1.0, 1e-5, s.mean_pos, self.velocity_weight)
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
        S = s.cpp + self._var(1.0, 1e-1, s.mean_pos, self.position_weight)
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

    def distance(self, s: KalmanState, z: torch.Tensor) -> torch.Tensor:
        """Squared Mahalanobis gating distance of z[..., K] to the states
        [..., K], summed component by component in index order."""
        mean_proj, S = self.project(s)
        nu = z - mean_proj
        d2 = torch.zeros_like(nu[..., 0])
        for k in range(nu.shape[-1]):
            d2 = d2 + nu[..., k] * nu[..., k] / S[..., k]
        return d2

    def distance_matrix(self, s: KalmanState, z: torch.Tensor,
                        s_floor: Optional[float] = None) -> torch.Tensor:
        """Squared Mahalanobis distance, states [..., T, K] x measurements
        [..., D, K] -> [..., D, T], summed component by component in index
        order; leading dims (a scene axis) broadcast."""
        mean_proj, S = self.project(s, s_floor)
        d2 = torch.zeros(z.shape[:-1] + mean_proj.shape[-2:-1],
                         dtype=z.dtype, device=z.device)
        for k in range(z.shape[-1]):
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


def make_candidate_states(spec: KalmanSpec, z: torch.Tensor) -> KalmanState:
    """A fresh candidate track's state: initiate -> predict -> update(z)
    (`kalman_prediction.rs:13-32`).  The mean equals z (zero innovation);
    the covariance seeds new tracks."""
    return spec.update(spec.predict(spec.initiate(z)), z)


def step_track_states(spec: KalmanSpec, s: KalmanState,
                      z: torch.Tensor) -> KalmanState:
    """One tracked-object step: predict -> update
    (`kalman_prediction.rs:22-26`)."""
    return spec.update(spec.predict(s), z)


def empty_state(n: int, dim: int = 5, device: DeviceLike = None) -> KalmanState:
    """Zero state for n rows; `device=None` means CUDA, as everywhere in
    the port."""
    dev = resolve_device(device)
    return KalmanState(*(torch.zeros(n, dim, dtype=torch.float32, device=dev)
                         for _ in range(5)))


def gather_state(s: KalmanState, idx: torch.Tensor) -> KalmanState:
    """The rows `idx` of every component."""
    return KalmanState(*(getattr(s, f.name)[idx]
                         for f in dataclasses.fields(s)))


def scatter_state(dst: KalmanState, idx: torch.Tensor, src: KalmanState,
                  mask: torch.Tensor) -> KalmanState:
    """`dst` with src's rows written at idx where mask; rows whose index
    is outside [0, n) are dropped, as the JAX package's `mode="drop"`
    drops them.  `dst` is not modified."""
    n = dst.mean_pos.shape[0]
    keep = mask & (idx >= 0) & (idx < n)
    rows = idx[keep]

    def put(d, v):
        out = d.clone()
        out[rows] = v[keep]
        return out

    return KalmanState(*(put(getattr(dst, f.name), getattr(src, f.name))
                         for f in dataclasses.fields(dst)))
