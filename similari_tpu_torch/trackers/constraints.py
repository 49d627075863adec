"""Spatio-temporal constraints: epoch delta vs distance gating (mirrors
`similari_tpu/trackers/constraints.py`).

A sorted list of (epoch_delta, max_dist_in_2r); validation picks the first
constraint with delta >= epoch_delta; an empty list always validates.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class SpatioTemporalConstraints:
    def __init__(self):
        self._constraints: list[Tuple[int, float]] = []

    def constraints(self, constraints: Sequence[Tuple[int, float]]):
        self.add_constraints(list(constraints))
        return self

    def add_constraints(self, constraints: Sequence[Tuple[int, float]]):
        for delta, max_distance in constraints:
            if not max_distance > 0.0:
                raise ValueError("The distance is expected to be a positive float")
            self._constraints.append((int(delta), float(max_distance)))
        self._constraints.sort(key=lambda e: e[0])
        # keep the first of each run of equal deltas
        dedup: list[Tuple[int, float]] = []
        for d, m in self._constraints:
            if dedup and dedup[-1][0] == d:
                continue
            dedup.append((d, m))
        self._constraints = dedup

    def validate(self, epoch_delta: int, dist: float) -> bool:
        if not dist >= 0.0:
            raise ValueError("The distance is expected to be a positive float")
        for d, max_dist in self._constraints:
            if d >= epoch_delta:
                return dist <= max_dist
        return True

    def as_tuple(self) -> Tuple[Tuple[int, float], ...]:
        return tuple(self._constraints)

    def __repr__(self):
        return f"SpatioTemporalConstraints({self._constraints})"


def allowed_distance_for_delta(constraints: Tuple[Tuple[int, float], ...],
                               delta: torch.Tensor) -> torch.Tensor:
    """The largest allowed dist_in_2r per epoch delta; +inf where no
    constraint applies."""
    allowed = torch.full(delta.shape, float("inf"), dtype=torch.float32,
                         device=delta.device)
    # descending, so the smallest applicable delta wins (first match)
    for d, max_dist in sorted(constraints, reverse=True):
        allowed = torch.where(delta <= d, max_dist, allowed)
    return allowed
