"""Example attribute and metric implementations and synthetic generators
(mirrors `similari_tpu/core/examples.py`).

Parity with the reference's `examples.rs` and `examples/iou.rs`: the
fixtures it uses in its tests, examples and benches.  `SimpleMetric`'s
feature distance is the port's `ops/distances.py::euclidean` on CPU
tensors.
"""

from __future__ import annotations

import time
from itertools import repeat
from typing import Dict, List, Optional

import numpy as np

from ..ops.distances import euclidean
from ..utils.bbox import BoundingBox
from .track import (
    LookupRequest,
    MetricQuery,
    NoopLookup,
    Observation,
    ObservationMetric,
    ObservationMetricOk,
    TrackAttributes,
    TrackAttributesUpdate,
    TrackStatus,
)


class SetError(Exception):
    pass


class Incompatible(Exception):
    pass


class SimpleAttrs(TrackAttributes):
    """One-shot set gate, `examples.rs:25-94`."""

    def __init__(self):
        self.set = False

    def compatible(self, other) -> bool:
        return self.set and other.set

    def merge(self, other):
        if not self.compatible(other):
            raise Incompatible()

    def baked(self, observations) -> TrackStatus:
        return TrackStatus.Ready if self.set else TrackStatus.Pending


class SimpleAttributeUpdate(TrackAttributesUpdate):
    def apply(self, attrs: SimpleAttrs):
        if attrs.set:
            raise SetError("attributes are already set")
        attrs.set = True


def _f32_metric(l, r) -> Optional[float]:
    """`utils/primitive.rs:3-16`: |l - r| when both present."""
    if l is None or r is None:
        return None
    return abs(float(l) - float(r))


class SimpleMetric(ObservationMetric):
    def metric(self, mq: MetricQuery):
        e1, e2 = mq.candidate_observation, mq.track_observation
        feat = None
        if e1.feature() is not None and e2.feature() is not None:
            feat = euclidean(e1.feature(), e2.feature())
        return (_f32_metric(e1.attr(), e2.attr()), feat)


class UnboundAttrs(TrackAttributes):
    """Always compatible/ready, `examples.rs:96-151`."""

    def compatible(self, other) -> bool:
        return True

    def merge(self, other):
        pass

    def baked(self, observations) -> TrackStatus:
        return TrackStatus.Ready


class UnboundAttributeUpdate(TrackAttributesUpdate):
    def apply(self, attrs):
        pass


class UnboundMetric(SimpleMetric):
    pass


class BatchedSimpleMetric(SimpleMetric):
    """SimpleMetric that opts into the store's batched feature sweep
    (`core/store.py:_distances_batched`): the store precomputes the whole
    euclidean matrix in one vectorized op and this metric reads each pair's
    value from `MetricQuery.precomputed_distance`."""

    supports_batch_features = "euclidean"

    def metric(self, mq: MetricQuery):
        if mq.precomputed_distance is not None:
            e1, e2 = mq.candidate_observation, mq.track_observation
            return (_f32_metric(e1.attr(), e2.attr()), mq.precomputed_distance)
        return super().metric(mq)

    def batch_records(self, from_id, to_ids, left_obs, right_attrs, pre):
        """Bulk record stream: the whole `ObservationMetricOk` list in one
        pass, the attribute part (|l - r|) vectorised over the store
        columns, no per-pair `MetricQuery` objects."""
        n = len(to_ids)
        tl = to_ids.tolist()
        # np.asarray silently coerces None -> nan for float dtypes, so the
        # None positions must be found explicitly (an exception-based probe
        # never fires) — and remapped by POSITION, not by x != x, so a
        # genuine float('nan') attribute stays nan exactly as the per-pair
        # `_f32_metric` returns it
        none_mask = [a is None for a in right_attrs]
        any_none = any(none_mask)
        if any_none:
            ra = np.array(
                [np.nan if m else float(a)
                 for a, m in zip(right_attrs, none_mask)],
                np.float64,
            )
        else:  # common case: all attrs plain floats, one C-loop convert
            ra = np.asarray(right_attrs, np.float64)
        out = []
        for i, lo in enumerate(left_obs):
            la = lo.attr()
            fd = np.asarray(pre[i], np.float64).tolist()
            if la is None:
                out.extend(map(ObservationMetricOk, repeat(from_id, n), tl,
                               repeat(None, n), fd))
                continue
            am = np.abs(float(la) - ra).tolist()
            if any_none:
                am = [None if m else x for x, m in zip(am, none_mask)]
            out.extend(map(ObservationMetricOk, repeat(from_id, n), tl,
                           am, fd))
        return out



class BBoxAttributes(TrackAttributes):
    """`examples/iou.rs:8-38`."""

    def __init__(self):
        self.bboxes: List[BoundingBox] = []

    def compatible(self, other) -> bool:
        return True

    def merge(self, other):
        self.bboxes.extend(other.bboxes)

    def baked(self, observations) -> TrackStatus:
        return TrackStatus.Ready


class BBoxAttributesUpdate(TrackAttributesUpdate):
    def apply(self, attrs):
        pass


class IOUMetric(ObservationMetric):
    """Aligned-IoU metric with 0.01 gate and bounded history, `iou.rs:40-88`."""

    def __init__(self, history: int = 3):
        self.history = history

    def metric(self, mq: MetricQuery):
        e1, e2 = mq.candidate_observation, mq.track_observation
        if e1.attr() is None or e2.attr() is None:
            return None
        iou = e1.attr().iou(e2.attr())
        if iou < 0.01:
            return None
        return (iou, None)

    def optimize(self, feature_class, merge_history, attrs, observations,
                 prev_length, is_merge):
        if not is_merge and observations[prev_length].attr() is not None:
            attrs.bboxes.append(observations[prev_length].attr())
        # keep the last `history` observations
        del observations[:-self.history]


def vec2(x: float, y: float) -> np.ndarray:
    return np.asarray([x, y], np.float32)


class FeatGen2:
    """Drifting 2-d feature stream, `examples.rs:157-186`."""

    def __init__(self, x: float, y: float, drift: float, seed=None):
        self.x, self.y, self.drift = x, y, drift
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Observation:
        self.x += self.rng.uniform(-self.drift, self.drift)
        self.y += self.rng.uniform(-self.drift, self.drift)
        return Observation(
            self.rng.uniform(-self.drift, self.drift) + 0.7, vec2(self.x, self.y)
        )


class BoxGen2:
    """Drifting bbox stream, `examples.rs:188-249`."""

    def __init__(self, x, y, width, height, pos_drift, box_drift, seed=None,
                 monotonous=False):
        self.x, self.y, self.width, self.height = x, y, width, height
        self.pos_lo = 0.0 if monotonous else -pos_drift
        self.pos_hi = pos_drift
        self.box_drift = box_drift
        self.rng = np.random.default_rng(seed)

    @classmethod
    def new_monotonous(cls, x, y, width, height, pos_drift, box_drift, seed=None):
        return cls(x, y, width, height, pos_drift, box_drift, seed, monotonous=True)

    def __iter__(self):
        return self

    def __next__(self) -> BoundingBox:
        self.x += self.rng.uniform(self.pos_lo, self.pos_hi)
        self.y += self.rng.uniform(self.pos_lo, self.pos_hi)
        self.width = max(1.0, self.width + self.rng.uniform(-self.box_drift, self.box_drift))
        self.height = max(1.0, self.height + self.rng.uniform(-self.box_drift, self.box_drift))
        return BoundingBox(self.x, self.y, self.width, self.height)


class FeatGen:
    """d-dim drifting feature stream, `examples.rs:266-293`."""

    def __init__(self, x: float, length: int, drift: float, seed=None):
        self.x, self.length, self.drift = x, length, drift
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Observation:
        v = self.x + self.rng.uniform(-self.drift, self.drift, self.length)
        return Observation(None, v.astype(np.float32))


def current_time_ms() -> int:
    return int(time.time() * 1000)


def current_time_sec() -> int:
    return int(time.time())
