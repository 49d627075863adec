"""Box types, polygon clipping, NMS and shape helpers."""

from .bbox import (  # noqa: F401
    BoundingBox,
    GenericBBoxConversionError,
    Polygon,
    Universal2DBox,
    normalize_angle,
)
