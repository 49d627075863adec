"""Generic track model: the extensible similarity-search engine core
(mirrors `similari_tpu/core/track.py`).

User-defined attributes, metrics and voting plug into `Track` /
`TrackStore` as the reference's traits do (`track.rs`).  The SORT and
VisualSORT trackers do not run on this engine (they are device steps and
fused kernels under `trackers/` and `ops/`); this layer is the reference's
extensibility surface: custom attributes, metrics, lookups and merge
semantics, with the same transactional behaviour.  Features are f32 numpy
vectors; the store (`core/store.py`) stacks them into one feature index on
its device for the batched distance sweep.
"""

from __future__ import annotations

import copy
import dataclasses
import secrets
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class TrackStatus(Enum):
    """`track.rs:203-211`."""

    Ready = 0
    Pending = 1
    Wasted = 2


class IncompatibleAttributes(Exception):
    pass


class ObservationForClassNotFound(Exception):
    pass


Feature = np.ndarray


def feature_from_vec(v) -> Feature:
    return np.asarray(v, np.float32).ravel()


class Observation:
    """(attributes, feature) pair, `track.rs:67-102`."""

    __slots__ = ("_attr", "_feature")

    def __init__(self, attr=None, feature=None):
        self._attr = attr
        self._feature = None if feature is None else feature_from_vec(feature)

    def attr(self):
        return self._attr

    def feature(self) -> Optional[Feature]:
        return self._feature

    def set_attr(self, attr):
        self._attr = attr

    def set_feature(self, feature):
        self._feature = None if feature is None else feature_from_vec(feature)

    def __repr__(self):
        return f"Observation(attr={self._attr}, feature={self._feature})"


@dataclasses.dataclass(slots=True)
class ObservationMetricOk:
    """Distance record, `track.rs:20-51`.

    slots=True: the record-stream query builds one of these per
    observation pair (10k+ per store sweep), and slotted construction is
    faster than a dict-backed dataclass.
    """

    from_id: int
    to_id: int
    attribute_metric: Optional[float]
    feature_distance: Optional[float]

    # rust-parity aliases
    @property
    def from_(self):
        return self.from_id

    @property
    def to(self):
        return self.to_id


@dataclasses.dataclass
class MetricQuery:
    """`track.rs:134-145`.

    `precomputed_distance` has no reference counterpart: when a metric
    declares `supports_batch_features` ("euclidean" or "cosine"), the store
    computes the whole candidate×track feature-distance matrix in one
    vectorized sweep and delivers each pair's value here, so the metric can
    skip the per-pair feature math (`core/store.py`).
    """

    feature_class: int
    candidate_attrs: Any
    candidate_observation: Observation
    track_attrs: Any
    track_observation: Observation
    precomputed_distance: Optional[float] = None


class TrackAttributes:
    """Trait surface of `track.rs:291-323`; subclass and override."""

    def compatible(self, other) -> bool:
        raise NotImplementedError

    def merge(self, other) -> None:
        raise NotImplementedError

    def baked(self, observations: Dict[int, List[Observation]]) -> TrackStatus:
        raise NotImplementedError


class TrackAttributesUpdate:
    """`track.rs:329-333`."""

    def apply(self, attrs) -> None:
        raise NotImplementedError


class LookupRequest:
    """`track.rs:215-284`."""

    def lookup(self, attributes, observations, merge_history) -> bool:
        raise NotImplementedError


class NoopLookup(LookupRequest):
    def lookup(self, attributes, observations, merge_history) -> bool:
        return False


class ObservationMetric:
    """Trait surface of `track.rs:152-197`."""

    def metric(self, mq: MetricQuery) -> Optional[Tuple[Optional[float], Optional[float]]]:
        raise NotImplementedError

    def optimize(
        self,
        feature_class: int,
        merge_history: Sequence[int],
        attrs,
        observations: List[Observation],
        prev_length: int,
        is_merge: bool,
    ) -> None:
        return None

    def postprocess_distances(
        self, unfiltered: List[ObservationMetricOk]
    ) -> List[ObservationMetricOk]:
        return unfiltered

    def batch_records(
        self,
        from_id: int,
        to_ids,  # int64[N] owning track id per store observation column
        left_obs: List[Observation],  # candidate observations (rows)
        right_attrs: List,  # observation attribute per column
        pre,  # f32[L, N] feature distances from the store-wide sweep
    ) -> Optional[List[ObservationMetricOk]]:
        """Optional bulk twin of `metric` for the store-wide record sweep.

        When a metric that declares `supports_batch_features` also
        implements this, `TrackStore.foreign_track_distances` skips the
        per-pair `MetricQuery` loop entirely and asks the metric for the
        whole record stream at once (per-pair Python object construction
        costs far more than the distance math).  Rows must be emitted in the reference's stream order:
        track-major, then candidate-observation, then track-observation
        (`store.rs:429-460` fan-in order per shard batch).  Return None to
        fall back to the per-pair path.
        """
        return None


class ChangeNotifier:
    """`track/notify.rs:1-10`."""

    def send(self, track_id: int):
        raise NotImplementedError


class NoopNotifier(ChangeNotifier):
    def send(self, track_id: int):
        pass


class Track:
    """Generic track object, `track.rs:344-657`."""

    def __init__(
        self,
        attributes: TrackAttributes,
        metric: ObservationMetric,
        notifier: Optional[ChangeNotifier] = None,
        track_id: Optional[int] = None,
    ):
        self.track_id = (
            track_id if track_id is not None else secrets.randbits(64)
        )
        self.attributes = attributes
        self.metric = metric
        self.notifier = notifier or NoopNotifier()
        self.observations: Dict[int, List[Observation]] = {}
        self.merge_history: List[int] = [self.track_id]

    # ------------------------------------------------------------------ api
    def get_track_id(self) -> int:
        return self.track_id

    def set_track_id(self, track_id: int):
        self.track_id = track_id
        self.merge_history = [track_id]

    def get_attributes(self):
        return self.attributes

    def get_merge_history(self) -> List[int]:
        return list(self.merge_history)

    def get_observations(self, feature_class: int) -> Optional[List[Observation]]:
        return self.observations.get(feature_class)

    def get_feature_classes(self) -> List[int]:
        return list(self.observations.keys())

    def add_observation(
        self,
        feature_class: int,
        feature_attributes=None,
        feature=None,
        track_attributes_update: Optional[TrackAttributesUpdate] = None,
    ) -> None:
        """Transactional add, `track.rs:447-503`: attrs/observations/metric
        are snapshotted and restored when the update or optimize fails."""
        last_attributes = copy.deepcopy(self.attributes)
        if track_attributes_update is not None:
            try:
                track_attributes_update.apply(self.attributes)
            except Exception:
                self.attributes = last_attributes
                raise

        if feature is None and feature_attributes is None:
            self.notifier.send(self.track_id)
            return

        last_observations = copy.deepcopy(self.observations)
        last_metric = copy.deepcopy(self.metric)
        self.observations.setdefault(feature_class, []).append(
            Observation(feature_attributes, feature)
        )
        observations = self.observations[feature_class]
        prev_length = len(observations) - 1
        try:
            self.metric.optimize(
                feature_class,
                self.merge_history,
                self.attributes,
                observations,
                prev_length,
                False,
            )
        except Exception:
            self.attributes = last_attributes
            self.observations = last_observations
            self.metric = last_metric
            raise
        self.notifier.send(self.track_id)

    def merge(self, other: "Track", classes: Sequence[int], merge_history: bool = True):
        """Transactional merge, `track.rs:522-588`."""
        last_attributes = copy.deepcopy(self.attributes)
        try:
            self.attributes.merge(other.attributes)
        except Exception:
            self.attributes = last_attributes
            raise

        last_observations = copy.deepcopy(self.observations)
        last_metric = copy.deepcopy(self.metric)

        for cls in classes:
            dest = self.observations.get(cls)
            src = other.observations.get(cls)
            if dest is not None and src is not None:
                prev_length = len(dest)
                dest.extend(copy.deepcopy(src))
            elif dest is None and src is not None:
                self.observations[cls] = copy.deepcopy(src)
                prev_length = 0
            elif dest is not None:
                prev_length = len(dest)
            else:
                prev_length = None

            # recomputed inside the class loop on purpose: the reference does
            # the same (`track.rs:555-563`), so a multi-class merge appends
            # `other`'s history once per optimized class — parity over tidiness
            if merge_history:
                mh = list(self.merge_history) + list(other.merge_history)
            else:
                mh = list(self.merge_history)
                self.merge_history = []

            if prev_length is not None:
                try:
                    self.metric.optimize(
                        cls,
                        mh,
                        self.attributes,
                        self.observations[cls],
                        prev_length,
                        True,
                    )
                except Exception:
                    self.attributes = last_attributes
                    self.observations = last_observations
                    self.metric = last_metric
                    raise
                self.merge_history = mh

        self.notifier.send(self.track_id)

    def distances(self, other: "Track", feature_class: int) -> List[ObservationMetricOk]:
        """Cartesian-product metric, `track.rs:604-652`."""
        if not self.attributes.compatible(other.attributes):
            raise IncompatibleAttributes(
                f"{self.track_id} incompatible with {other.track_id}"
            )
        left = self.observations.get(feature_class)
        right = other.observations.get(feature_class)
        if left is None or right is None:
            raise ObservationForClassNotFound(
                f"class {feature_class} for {self.track_id}/{other.track_id}"
            )
        out = []
        for l in left:
            for r in right:
                mq = MetricQuery(
                    feature_class=feature_class,
                    candidate_attrs=self.attributes,
                    candidate_observation=l,
                    track_attrs=other.attributes,
                    track_observation=r,
                )
                res = self.metric.metric(mq)
                if res is None:
                    continue
                attribute_metric, feature_distance = res
                out.append(
                    ObservationMetricOk(
                        from_id=self.track_id,
                        to_id=other.track_id,
                        attribute_metric=attribute_metric,
                        feature_distance=feature_distance,
                    )
                )
        return out

    def lookup(self, query: LookupRequest) -> bool:
        return query.lookup(self.attributes, self.observations, self.merge_history)


class ObservationBuilder:
    """`track/builder.rs:120-180`."""

    def __init__(self, feature_class: int):
        self._feature_class = feature_class
        self._attributes = None
        self._feature = None
        self._update = None

    def observation_attributes(self, attrs):
        self._attributes = attrs
        return self

    def observation(self, feature):
        self._feature = feature
        return self

    def track_attributes_update(self, update):
        self._update = update
        return self

    def build(self):
        return (self._feature_class, self._attributes, self._feature, self._update)


class TrackBuilder:
    """`track/builder.rs:10-118`."""

    def __init__(self, track_id: Optional[int] = None):
        self._track_id = track_id if track_id is not None else secrets.randbits(64)
        self._attributes = None
        self._metric = None
        self._notifier = None
        self._observations = []

    def track_id(self, track_id: int):
        self._track_id = track_id
        return self

    def attributes(self, attrs):
        self._attributes = attrs
        return self

    def metric(self, metric):
        self._metric = metric
        return self

    def notifier(self, notifier):
        self._notifier = notifier
        return self

    def observation(self, observation):
        self._observations.append(observation)
        return self

    def build(self) -> Track:
        track = Track(
            attributes=copy.deepcopy(self._attributes),
            metric=copy.deepcopy(self._metric),
            notifier=self._notifier,
            track_id=self._track_id,
        )
        for (cls, attrs, feature, update) in self._observations:
            track.add_observation(cls, attrs, feature, update)
        return track
