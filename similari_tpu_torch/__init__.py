"""PyTorch/CUDA port of similari_tpu for NVIDIA Hopper (H100).

The JAX package `similari_tpu` is the reference this package is held
against; nothing here imports it or JAX.  Entry points run on the card
(`device=None` means CUDA) and raise when CUDA is missing; the CPU is used
only when the caller passes `device="cpu"`.

The public API mirrors the reference's Python module: the trackers `Sort`,
`VisualSort`, `BatchSort` and `BatchVisualSort` with their request, result
and track types (`trackers/`), `Universal2DBox` and the box types,
`nms()`, and the f64 polygon clipping (`sutherland_hodgman_clip`,
`intersection_area`, `exclusively_owned_areas(_normalized_shares)`) under
`utils/`.  Below them: the general SORT and VisualSORT steps
(`trackers/sort_step.py`, `trackers/visual_step.py`), their batched forms
(`parallel/mesh.py`), the fused sequence pipelines (`ops/fused_sort.py`,
`ops/fused_visual.py`, `eval/mot.py`) and block-skip NMS (`ops/nms.py`).
Beside them: the generic track / store engine (`core/`, its feature
sweep on the store's device), the CLEAR / Identity metrics and synthetic
sequences (`eval/`) and the MOTChallenge kit (`motchallenge/`).

Five hand-written CUDA C++ kernels for `sm_90a` under `csrc/` carry them:
the fused SORT frame kernel and the fused VisualSORT frame kernel
(`fused_track.cu`), the VisualSORT chunk's gallery product
(`gallery_dots.cu`, `ops/gallery_dots.py`), the rotated-box clip
(`clip.cu`, `ops/clip.py`: oriented `Sort` and `nms()`) and the in-place
batched gallery merge (`merge.cu`, `ops/merge_inplace.py`:
`BatchVisualSort`).
"""

from .device import resolve_device  # noqa: F401
from .version import __version__, version  # noqa: F401
from .utils.bbox import (  # noqa: F401
    BoundingBox,
    GenericBBoxConversionError,
    Polygon,
    Universal2DBox,
)
from .utils.clipping import (  # noqa: F401
    exclusively_owned_areas,
    exclusively_owned_areas_normalized_shares,
    intersection_area,
    sutherland_hodgman_clip,
)
from .utils.nms import nms  # noqa: F401
from .utils.kalman import (  # noqa: F401
    Point2DKalmanFilter,
    Point2DKalmanFilterState,
    Universal2DBoxKalmanFilter,
    Universal2DBoxKalmanFilterState,
    Vec2DKalmanFilter,
)
from .ops.distances import cosine, euclidean  # noqa: F401
from .trackers import (  # noqa: F401
    BatchSort,
    BatchVisualSort,
    FeatureTracker,
    PositionalMetricType,
    PredictionBatchResult,
    SortPredictionBatchRequest,
    VisualSortPredictionBatchRequest,
    Sort,
    SortTrack,
    SpatioTemporalConstraints,
    VisualSort,
    VisualSortMetricType,
    VisualSortObservation,
    VisualSortObservationSet,
    VisualSortOptions,
    VotingType,
    WastedSortTrack,
    WastedVisualSortTrack,
)
