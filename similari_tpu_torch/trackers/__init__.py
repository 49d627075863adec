"""Tracker states, configurations and the public trackers."""

from .constraints import SpatioTemporalConstraints  # noqa: F401
from .feature import FeatureTracker  # noqa: F401
from .sort import (  # noqa: F401
    PositionalMetricType,
    Sort,
    SortTrack,
    VotingType,
    WastedSortTrack,
)
from .batch import (  # noqa: F401
    BatchSort,
    BatchVisualSort,
    PredictionBatchResult,
    SortPredictionBatchRequest,
    VisualSortPredictionBatchRequest,
)
from .visual import (  # noqa: F401
    VisualSort,
    VisualSortMetricType,
    VisualSortObservation,
    VisualSortObservationSet,
    VisualSortOptions,
    WastedVisualSortTrack,
)
