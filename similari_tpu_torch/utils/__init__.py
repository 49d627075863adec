"""Box types, polygon clipping, NMS, shape helpers, checkpoints and
step timing."""

from .bbox import (  # noqa: F401
    BoundingBox,
    GenericBBoxConversionError,
    Polygon,
    Universal2DBox,
    normalize_angle,
)
from .checkpoint import load_tracker, save_tracker  # noqa: F401
from .profiling import StepTimer, trace  # noqa: F401
