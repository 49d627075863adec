"""The generic track / store engine (mirrors `similari_tpu/core/`):
`Track`, `TrackStore` with its feature sweep on the store's device, and
the voting engines."""

from .track import (  # noqa: F401
    ChangeNotifier,
    Feature,
    IncompatibleAttributes,
    LookupRequest,
    MetricQuery,
    NoopLookup,
    NoopNotifier,
    Observation,
    ObservationBuilder,
    ObservationForClassNotFound,
    ObservationMetric,
    ObservationMetricOk,
    Track,
    TrackAttributes,
    TrackAttributesUpdate,
    TrackBuilder,
    TrackStatus,
    feature_from_vec,
)
from .store import (  # noqa: F401
    DuplicateTrackId,
    SameTrackCalculation,
    TrackNotFound,
    TrackStore,
    TrackStoreBuilder,
)
from .voting import BestFitVoting, TopNVoting, TopNVotingElt, Voting  # noqa: F401
