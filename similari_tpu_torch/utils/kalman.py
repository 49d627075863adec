"""Public Kalman filter API classes (mirrors `similari_tpu/utils/kalman.py`;
the reference's pyo3 surface of `utils/kalman/`).

`Universal2DBoxKalmanFilter(+State)`, `Point2DKalmanFilter(+State)` and
`Vec2DKalmanFilter` run the recurrences of `ops/kalman.py` in numpy on the
host: a single filter step, or one track's sequence, is host-scale work.
`filter_sequence` runs the whole sequence in one call of the port's C++
loop (`native.py::kf_box_sequence` / `kf_point_sequence`), as the JAX
module does when its library builds; `box_sequence_numpy` and
`point_sequence_numpy` are the JAX module's NumPy loops, op for op, kept
as their plain twins.  Unlike the JAX module it checks its input's shape
first: boxes [N, 5], points [N, 2], keypoint vectors [N, P, 2]; anything
else raises ValueError.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import native
from ..ops import kalman as K
from .bbox import BoundingBox, Universal2DBox

CHI2INV95 = K.CHI2INV95
CHI2_UPPER_BOUND = K.CHI2_UPPER_BOUND


class _NpState:
    """Decomposed (mean_pos, mean_vel, cpp, cpv, cvv) state in numpy."""

    __slots__ = ("mean_pos", "mean_vel", "cpp", "cpv", "cvv")

    def __init__(self, mean_pos, mean_vel, cpp, cpv, cvv):
        self.mean_pos = np.asarray(mean_pos, np.float32)
        self.mean_vel = np.asarray(mean_vel, np.float32)
        self.cpp = np.asarray(cpp, np.float32)
        self.cpv = np.asarray(cpv, np.float32)
        self.cvv = np.asarray(cvv, np.float32)


class _NpFilter:
    """Numpy mirror of ops.kalman.KalmanSpec (same recurrences)."""

    def __init__(self, position_weight, velocity_weight, kind):
        self.pw = float(position_weight)
        self.vw = float(velocity_weight)
        self.kind = kind

    def _stds(self, k, cnst, p, w):
        if self.kind == "box":
            s = k * w * p
            return np.array([s, s, s, cnst, s], np.float32)
        s = k * w
        return np.array([s, s], np.float32)

    def initiate(self, z):
        z = np.asarray(z, np.float32)
        p = z[4] if self.kind == "box" else None
        sp = self._stds(2.0, 1e-2, p, self.pw)
        sv = self._stds(10.0, 1e-5, p, self.vw)
        return _NpState(z, np.zeros_like(z), sp * sp, np.zeros_like(z), sv * sv)

    def predict(self, s: _NpState):
        p = s.mean_pos[4] if self.kind == "box" else None
        qp = self._stds(1.0, 1e-2, p, self.pw) ** 2
        qv = self._stds(1.0, 1e-5, p, self.vw) ** 2
        return _NpState(
            s.mean_pos + s.mean_vel,
            s.mean_vel,
            s.cpp + 2 * s.cpv + s.cvv + qp,
            s.cpv + s.cvv,
            s.cvv + qv,
        )

    def project(self, s: _NpState):
        p = s.mean_pos[4] if self.kind == "box" else None
        r = self._stds(1.0, 1e-1, p, self.pw) ** 2
        return s.mean_pos, s.cpp + r

    def update(self, s: _NpState, z):
        z = np.asarray(z, np.float32)
        mean_proj, S = self.project(s)
        nu = z - mean_proj
        gp = s.cpp / S
        gv = s.cpv / S
        return _NpState(
            s.mean_pos + nu * gp,
            s.mean_vel + nu * gv,
            s.cpp - s.cpp * gp,
            s.cpv - s.cpp * gv,
            s.cvv - s.cpv * gv,
        )

    def distance(self, s: _NpState, z):
        z = np.asarray(z, np.float32)
        mean_proj, S = self.project(s)
        nu = z - mean_proj
        return float(np.sum(nu * nu / S))


def _checked(a, tail, name: str, want: str) -> np.ndarray:
    """`a` as a contiguous f32 array of shape [N, *tail] (None in `tail`:
    any size); ValueError otherwise."""
    z = np.ascontiguousarray(a, np.float32)
    ok = z.ndim == 1 + len(tail) and all(
        t is None or z.shape[1 + i] == t for i, t in enumerate(tail))
    if not ok:
        raise ValueError(f"{name} must be {want}, got shape {z.shape}")
    return z


def _sequence_numpy(f: "_NpFilter", z: np.ndarray) -> np.ndarray:
    """Initiate from z[0], then predict and update per row: the filtered
    means [N, D] of one chain z [N, D] (N >= 1)."""
    out = np.empty_like(z)
    s = f.initiate(z[0])
    out[0] = s.mean_pos
    for i in range(1, z.shape[0]):
        s = f.update(f.predict(s), z[i])
        out[i] = s.mean_pos
    return out


def box_sequence_numpy(boxes: np.ndarray, position_weight: float,
                       velocity_weight: float) -> np.ndarray:
    """The plain twin of `Universal2DBoxKalmanFilter.filter_sequence`."""
    z = _checked(boxes, (5,), "boxes", "[N, 5]")
    if z.shape[0] == 0:
        return z
    return _sequence_numpy(_NpFilter(position_weight, velocity_weight,
                                     "box"), z)


def point_sequence_numpy(points: np.ndarray, position_weight: float,
                         velocity_weight: float) -> np.ndarray:
    """The plain twin of the point filters' `filter_sequence`: points
    [N, 2], or [N, P, 2] chain by chain."""
    tail = (2,) if np.ndim(points) <= 2 else (None, 2)
    z = _checked(points, tail, "points", "[N, 2] or [N, P, 2]")
    if z.size == 0:
        return z
    f = _NpFilter(position_weight, velocity_weight, "point")
    if z.ndim == 2:
        return _sequence_numpy(f, z)
    return np.stack([_sequence_numpy(f, z[:, p]) for p in range(z.shape[1])],
                    axis=1)


def _box_to_z(b: Universal2DBox) -> np.ndarray:
    return np.array(
        [b.xc, b.yc, b.angle if b.angle is not None else 0.0, b.aspect, b.height],
        np.float32,
    )


class Universal2DBoxKalmanFilterState:
    def __init__(self, state: _NpState):
        self._state = state

    def universal_bbox(self) -> Universal2DBox:
        m = self._state.mean_pos
        return Universal2DBox.from_vec5(m)

    def bbox(self) -> BoundingBox:
        return self.universal_bbox().as_ltwh()


class Universal2DBoxKalmanFilter:
    """DeepSORT-style box filter, `kalman_2d_box.rs:29-184`."""

    def __init__(self, position_weight: float = 0.05, velocity_weight: float = 0.00625):
        self._f = _NpFilter(position_weight, velocity_weight, "box")

    def initiate(self, bbox: Universal2DBox) -> Universal2DBoxKalmanFilterState:
        return Universal2DBoxKalmanFilterState(self._f.initiate(_box_to_z(bbox)))

    def predict(self, state: Universal2DBoxKalmanFilterState):
        return Universal2DBoxKalmanFilterState(self._f.predict(state._state))

    def update(self, state: Universal2DBoxKalmanFilterState, bbox: Universal2DBox):
        return Universal2DBoxKalmanFilterState(
            self._f.update(state._state, _box_to_z(bbox))
        )

    def distance(self, state: Universal2DBoxKalmanFilterState, bbox: Universal2DBox) -> float:
        return self._f.distance(state._state, _box_to_z(bbox))

    @staticmethod
    def calculate_cost(distance: float, inverted: bool) -> float:
        """`kalman_2d_box.rs:172-184` (chi2 gate at dof-5)."""
        gate = CHI2INV95[4]
        if not inverted:
            return CHI2_UPPER_BOUND if distance > gate else distance
        return 0.0 if distance > gate else CHI2_UPPER_BOUND - distance

    def filter_sequence(self, boxes: np.ndarray) -> np.ndarray:
        """Bulk smoothing of one track: boxes[N, 5] vec5 -> filtered means
        [N, 5] (initiate from row 0, then predict+update per row — the
        `benches/kalman_bbox.rs:15-31` loop as one native call)."""
        z = _checked(boxes, (5,), "boxes", "[N, 5]")
        if z.shape[0] == 0:
            return np.zeros((0, 5), np.float32)
        return native.kf_box_sequence(z, self._f.pw, self._f.vw)


class Point2DKalmanFilterState:
    def __init__(self, state: _NpState):
        self._state = state

    def x(self) -> float:
        return float(self._state.mean_pos[0])

    def y(self) -> float:
        return float(self._state.mean_pos[1])


class Point2DKalmanFilter:
    """2D point filter, `kalman_2d_point.rs:25-152`."""

    def __init__(self, position_weight: float = 0.05, velocity_weight: float = 0.00625):
        self._f = _NpFilter(position_weight, velocity_weight, "point")

    def initiate(self, x: float, y: float) -> Point2DKalmanFilterState:
        return Point2DKalmanFilterState(self._f.initiate([x, y]))

    def predict(self, state: Point2DKalmanFilterState):
        return Point2DKalmanFilterState(self._f.predict(state._state))

    def update(self, state: Point2DKalmanFilterState, x: float, y: float):
        return Point2DKalmanFilterState(self._f.update(state._state, [x, y]))

    def distance(self, state: Point2DKalmanFilterState, x: float, y: float) -> float:
        return self._f.distance(state._state, [x, y])

    @staticmethod
    def calculate_cost(distance: float, inverted: bool) -> float:
        """`kalman_2d_point.rs:139-151` (dof-2 gate plain, dof-5 inverted —
        kept as in the reference)."""
        if not inverted:
            return CHI2_UPPER_BOUND if distance > CHI2INV95[1] else distance
        return 0.0 if distance > CHI2INV95[4] else CHI2_UPPER_BOUND - distance

    def filter_sequence(self, points: np.ndarray) -> np.ndarray:
        """Bulk smoothing of one point track: points[N, 2] -> filtered means
        [N, 2] (initiate from row 0, then predict+update per row — the
        `benches/kalman_2d_point.rs:11-24` loop as one native call)."""
        z = _checked(points, (2,), "points", "[N, 2]")
        if z.shape[0] == 0:
            return np.zeros((0, 2), np.float32)
        return native.kf_point_sequence(z, self._f.pw, self._f.vw)


class Vec2DKalmanFilter:
    """Maps the point filter over keypoint vectors, `kalman_2d_point_vec.rs:5-77`."""

    def __init__(self, position_weight: float = 0.05, velocity_weight: float = 0.00625):
        self._f = Point2DKalmanFilter(position_weight, velocity_weight)

    def initiate(self, points: Sequence[Tuple[float, float]]) -> List[Point2DKalmanFilterState]:
        return [self._f.initiate(x, y) for x, y in points]

    def predict(self, state: Sequence[Point2DKalmanFilterState]):
        return [self._f.predict(s) for s in state]

    def update(
        self,
        state: Sequence[Point2DKalmanFilterState],
        points: Sequence[Tuple[float, float]],
    ):
        assert len(state) == len(points), "Lengths of state and points must match"
        return [self._f.update(s, x, y) for s, (x, y) in zip(state, points)]

    def distance(self, state, points) -> List[float]:
        assert len(state) == len(points), "Lengths of state and points must match"
        return [self._f.distance(s, x, y) for s, (x, y) in zip(state, points)]

    @staticmethod
    def calculate_cost(distances: Sequence[float], inverted: bool) -> List[float]:
        return [Point2DKalmanFilter.calculate_cost(d, inverted) for d in distances]

    def filter_sequence(self, points: np.ndarray) -> np.ndarray:
        """Bulk smoothing of a keypoint-vector track: points[N, P, 2] (P
        independent chains advancing together) -> filtered means [N, P, 2],
        every chain in one native call."""
        z = _checked(points, (None, 2), "points", "[N, P, 2]")
        if z.shape[0] == 0 or z.shape[1] == 0:
            return np.zeros_like(z)
        return native.kf_point_sequence(z, self._f._f.pw, self._f._f.vw)
