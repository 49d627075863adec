"""User-facing box types (a NumPy copy of `similari_tpu/utils/bbox.py`).

`BoundingBox` (LTWH) and `Universal2DBox` (xc, yc, angle, aspect, height)
mirror the reference's `src/utils/bbox.rs:10-238` and its pyo3 bindings.
These are thin host objects; the trackers pack them into box tensors
([N, 5] = xc, yc, angle-or-0, aspect, height) for `ops/geometry.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


class GenericBBoxConversionError(ValueError):
    pass


@dataclass
class BoundingBox:
    """Axis-aligned box (left, top, width, height) + confidence, `bbox.rs:10-75`."""

    left: float
    top: float
    width: float
    height: float
    confidence: float = 1.0

    def __init__(self, left: float, top: float, width: float, height: float):
        self.left = float(left)
        self.top = float(top)
        self.width = float(width)
        self.height = float(height)
        self.confidence = 1.0

    @staticmethod
    def new_with_confidence(
        left: float, top: float, width: float, height: float, confidence: float
    ) -> "BoundingBox":
        if not (0.0 <= confidence <= 1.0):
            raise ValueError("Confidence must lay between 0.0 and 1.0")
        b = BoundingBox(left, top, width, height)
        b.confidence = float(confidence)
        return b

    def as_xyaah(self) -> "Universal2DBox":
        return Universal2DBox.from_ltwh(self)

    @staticmethod
    def intersection(l: "BoundingBox", r: "BoundingBox") -> float:
        """`bbox.rs:54-75`."""
        assert l.width > 0 and l.height > 0 and r.width > 0 and r.height > 0
        x1 = max(l.left, r.left)
        y1 = max(l.top, r.top)
        x2 = min(l.left + l.width, r.left + r.width)
        y2 = min(l.top + l.height, r.top + r.height)
        iw, ih = x2 - x1, y2 - y1
        return float(iw * ih) if iw > 0 and ih > 0 else 0.0

    def iou(self, other: "BoundingBox") -> float:
        inter = BoundingBox.intersection(self, other)
        union = self.height * self.width + other.height * other.width - inter
        return inter / union

    def __eq__(self, other) -> bool:
        eps = 1e-5
        return (
            abs(self.left - other.left) < eps
            and abs(self.top - other.top) < eps
            and abs(self.width - other.width) < eps
            and abs(self.height - other.height) < eps
        )

    def __repr__(self) -> str:
        return (
            f"BoundingBox(left={self.left}, top={self.top}, width={self.width}, "
            f"height={self.height}, confidence={self.confidence})"
        )


class Polygon:
    """Vertex list result of clipping (mirrors the reference PyPolygon)."""

    def __init__(self, points: Sequence[tuple]):
        self._points = [(float(x), float(y)) for x, y in points]

    def get_points(self):
        return list(self._points)

    def area(self) -> float:
        pts = self._points
        n = len(pts)
        if n < 3:
            return 0.0
        s = 0.0
        for i in range(n):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % n]
            s += x1 * y2 - x2 * y1
        return abs(s) * 0.5

    def __len__(self):
        return len(self._points)

    def __repr__(self):
        return f"Polygon({self._points})"


@dataclass
class Universal2DBox:
    """Rotated/universal box (xc, yc, angle, aspect, height), `bbox.rs:78-238`."""

    xc: float
    yc: float
    angle: Optional[float]
    aspect: float
    height: float
    confidence: float = 1.0

    def __init__(
        self,
        xc: float,
        yc: float,
        angle: Optional[float],
        aspect: float,
        height: float,
    ):
        self.xc = float(xc)
        self.yc = float(yc)
        self.angle = None if angle is None else float(angle)
        self.aspect = float(aspect)
        self.height = float(height)
        self.confidence = 1.0

    @staticmethod
    def new_with_confidence(
        xc: float,
        yc: float,
        angle: Optional[float],
        aspect: float,
        height: float,
        confidence: float,
    ) -> "Universal2DBox":
        if not (0.0 <= confidence <= 1.0):
            raise ValueError("Confidence must lay between 0.0 and 1.0")
        b = Universal2DBox(xc, yc, angle, aspect, height)
        b.confidence = float(confidence)
        return b

    @staticmethod
    def ltwh(left: float, top: float, width: float, height: float) -> "Universal2DBox":
        return BoundingBox(left, top, width, height).as_xyaah()

    @staticmethod
    def ltwh_with_confidence(
        left: float, top: float, width: float, height: float, confidence: float
    ) -> "Universal2DBox":
        return BoundingBox.new_with_confidence(
            left, top, width, height, confidence
        ).as_xyaah()

    @staticmethod
    def from_ltwh(f: BoundingBox) -> "Universal2DBox":
        """`bbox.rs:246-258`."""
        b = Universal2DBox(
            xc=f.left + f.width / 2.0,
            yc=f.top + f.height / 2.0,
            angle=None,
            aspect=f.width / f.height,
            height=f.height,
        )
        b.confidence = f.confidence
        return b

    def as_ltwh(self) -> BoundingBox:
        """`bbox.rs:268-285`; fails when the box is rotated."""
        if self.angle is not None and self.angle != 0.0:
            raise GenericBBoxConversionError(
                "Cannot convert rotated Universal2DBox to BoundingBox"
            )
        width = self.height * self.aspect
        return BoundingBox.new_with_confidence(
            self.xc - width / 2.0,
            self.yc - self.height / 2.0,
            width,
            self.height,
            self.confidence,
        )

    def get_radius(self) -> float:
        hw = self.aspect * self.height / 2.0
        hh = self.height / 2.0
        return math.sqrt(hw * hw + hh * hh)

    def area(self) -> float:
        return self.aspect * self.height * self.height

    def rotate(self, angle: float) -> "Universal2DBox":
        """Sets the angle (in place, like the pyo3 binding) and returns self."""
        self.angle = float(angle)
        return self

    def set_confidence(self, confidence: float):
        if not (0.0 <= confidence <= 1.0):
            raise ValueError("Confidence must lay between 0.0 and 1.0")
        self.confidence = float(confidence)

    def get_vertices(self) -> Polygon:
        """Corner polygon in the reference's vertex order, `bbox.rs:287-330`."""
        angle = self.angle if self.angle is not None else 0.0
        c, s = math.cos(angle), math.sin(angle)
        hw = self.height * self.aspect / 2.0
        hh = self.height / 2.0
        r1x = -hw * c - hh * s
        r1y = -hw * s + hh * c
        r2x = hw * c - hh * s
        r2y = hw * s + hh * c
        x, y = self.xc, self.yc
        return Polygon(
            [(x + r1x, y + r1y), (x + r2x, y + r2y), (x - r1x, y - r1y), (x - r2x, y - r2y)]
        )

    # --- tensor conversion -------------------------------------------------
    def to_vec5(self) -> np.ndarray:
        return np.array(
            [
                self.xc,
                self.yc,
                self.angle if self.angle is not None else 0.0,
                self.aspect,
                self.height,
            ],
            np.float32,
        )

    @staticmethod
    def from_vec5(v, confidence: float = 1.0) -> "Universal2DBox":
        # hot on the interactive result path (2 boxes per output track):
        # one tolist() call converts the row, object.__new__ skips __init__
        if isinstance(v, np.ndarray):
            v = v.tolist()
        xc, yc, angle, aspect, height = (
            v if type(v) is list and type(v[0]) is float
            else (float(v[0]), float(v[1]), float(v[2]), float(v[3]),
                  float(v[4]))
        )
        b = object.__new__(Universal2DBox)
        b.xc = xc
        b.yc = yc
        b.angle = None if angle == 0.0 else angle
        b.aspect = aspect
        b.height = height
        b.confidence = float(confidence)
        return b

    @staticmethod
    def too_far(l: "Universal2DBox", r: "Universal2DBox") -> bool:
        md = l.get_radius() + r.get_radius()
        dx, dy = l.xc - r.xc, l.yc - r.yc
        return dx * dx + dy * dy > md * md

    @staticmethod
    def dist_in_2r(l: "Universal2DBox", r: "Universal2DBox") -> float:
        rd = l.get_radius() + r.get_radius()
        dx, dy = l.xc - r.xc, l.yc - r.yc
        return math.sqrt(dx * dx + dy * dy) / math.sqrt(rd * rd + 1e-5)

    def __eq__(self, other) -> bool:
        eps = 1e-5
        return (
            abs(self.xc - other.xc) < eps
            and abs(self.yc - other.yc) < eps
            and abs((self.angle or 0.0) - (other.angle or 0.0)) < eps
            and abs(self.aspect - other.aspect) < eps
            and abs(self.height - other.height) < eps
        )

    def __repr__(self) -> str:
        return (
            f"Universal2DBox(xc={self.xc}, yc={self.yc}, angle={self.angle}, "
            f"aspect={self.aspect}, height={self.height}, confidence={self.confidence})"
        )


def boxes_to_tensor(boxes: Sequence[Universal2DBox]):
    """Pack host boxes into ([N,5] f32, conf[N] f32) numpy arrays."""
    n = len(boxes)
    out = np.zeros((n, 5), np.float32)
    conf = np.ones((n,), np.float32)
    for i, b in enumerate(boxes):
        out[i] = b.to_vec5()
        conf[i] = b.confidence
    return out, conf


def normalize_angle(a: float) -> float:
    pix2 = 2.0 * math.pi
    n = math.floor(a / pix2)
    a = a - n * pix2
    return a + pix2 if a < 0.0 else a
