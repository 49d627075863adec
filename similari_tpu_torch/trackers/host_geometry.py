"""NumPy twin of the device rotated IoU (mirrors
`similari_tpu/trackers/host_geometry.py`).

The host engines (`host_sort.py`, `host_visual.py`) must give the device
step's ids, so the rotated-box intersection here is a literal f32
transliteration of the JAX package's `geometry.quad_intersection_area`:
the same boundary-integral formulation with per-edge Liang-Barsky
clipping, the same pair recentring, the same op order, and not the
reference's f64 Sutherland-Hodgman clip (`utils/clipping.py`).  It stays
NumPy, op for op the JAX package's host copy, so the two are bit-equal.
"""

from __future__ import annotations

import numpy as np

_F1 = np.float32(1.0)
_F0 = np.float32(0.0)
_FH = np.float32(0.5)


def box_radius_np(b: np.ndarray) -> np.ndarray:
    """Enclosing-circle radius (`bbox.rs:157-161`), boxes [..., 5]."""
    hw = b[..., 3] * b[..., 4] * _FH
    hh = b[..., 4] * _FH
    return np.sqrt(hw * hw + hh * hh)


def box_area_np(b: np.ndarray) -> np.ndarray:
    """w*h = aspect*height^2 (`bbox.rs:163-166`)."""
    return b[..., 3] * b[..., 4] * b[..., 4]


def box_vertices_np(boxes: np.ndarray) -> np.ndarray:
    """Rotated-rect corners [..., 4, 2] (geometry.box_vertices order)."""
    angle = boxes[..., 2]
    c = np.cos(angle)
    s = np.sin(angle)
    hw = boxes[..., 3] * boxes[..., 4] * _FH
    hh = boxes[..., 4] * _FH
    r1x = -hw * c - hh * s
    r1y = -hw * s + hh * c
    r2x = hw * c - hh * s
    r2y = hw * s + hh * c
    x = boxes[..., 0]
    y = boxes[..., 1]
    return np.stack(
        [
            np.stack([x + r1x, y + r1y], axis=-1),
            np.stack([x + r2x, y + r2y], axis=-1),
            np.stack([x - r1x, y - r1y], axis=-1),
            np.stack([x - r2x, y - r2y], axis=-1),
        ],
        axis=-2,
    )


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _boundary_integral_np(A: np.ndarray, B: np.ndarray,
                          tie_pass: bool) -> np.ndarray:
    """Transliteration of `geometry._boundary_integral` (same op order)."""
    total = np.zeros(A.shape[:-2], A.dtype)
    for i in range(4):
        sx = A[..., i, 0]
        sy = A[..., i, 1]
        ex = A[..., (i + 1) % 4, 0]
        ey = A[..., (i + 1) % 4, 1]
        dex = ex - sx
        dey = ey - sy
        t0 = np.zeros_like(sx)
        t1 = np.ones_like(sx)
        ok = np.ones(sx.shape, bool)
        for h in range(4):
            px = B[..., h, 0]
            py = B[..., h, 1]
            dx = B[..., (h + 1) % 4, 0] - px
            dy = B[..., (h + 1) % 4, 1] - py
            a = _cross2(dx, dy, sx - px, sy - py)
            b = _cross2(dx, dy, dex, dey)
            tt = -a / np.where(b == _F0, _F1, b)
            t0 = np.where(b < _F0, np.maximum(t0, tt), t0)
            t1 = np.where(b > _F0, np.minimum(t1, tt), t1)
            para_out = (b == _F0) & (a > _F0)
            if tie_pass:
                same_dir = dx * dex + dy * dey >= _F0
                para_out = para_out | ((b == _F0) & (a == _F0) & same_dir)
            ok = ok & ~para_out
        p0x = sx + t0 * dex
        p0y = sy + t0 * dey
        p1x = sx + t1 * dex
        p1y = sy + t1 * dey
        contrib = _cross2(p0x, p0y, p1x, p1y)
        total = total + np.where(ok & (t1 > t0), contrib, _F0)
    return total


def rotated_intersection_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection area of boxes [..., 5] (geometry.rotated_intersection).

    too_far pairs are exactly 0; the pair is recentred around the midpoint
    of the two centers before clipping (f32-origin stability, same as the
    device kernel).
    """
    shape = np.broadcast_shapes(a.shape, b.shape)
    a = np.broadcast_to(a, shape).astype(np.float32, copy=False)
    b = np.broadcast_to(b, shape).astype(np.float32, copy=False)
    mid = _FH * (a[..., :2] + b[..., :2])
    ac = np.concatenate([a[..., :2] - mid, a[..., 2:]], axis=-1)
    bc = np.concatenate([b[..., :2] - mid, b[..., 2:]], axis=-1)
    va = box_vertices_np(ac)
    vb = box_vertices_np(bc)
    area = np.abs(
        _boundary_integral_np(va, vb, tie_pass=False)
        + _boundary_integral_np(vb, va, tie_pass=True)
    ) * _FH
    md = box_radius_np(a) + box_radius_np(b)
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    too_far = dx * dx + dy * dy > md * md
    return np.where(too_far, _F0, area)


def rotated_iou_matrix_np(det: np.ndarray, trk: np.ndarray):
    """Pairwise rotated IoU det[D,5] x trk[C,5] -> (iou[D,C], valid[D,C])."""
    inter = rotated_intersection_np(det[:, None, :], trk[None, :, :])
    union = box_area_np(det)[:, None] + box_area_np(trk)[None, :] - inter
    # union > 0 guards degenerate zero-area boxes (geometry.universal_iou
    # parity — see the note there)
    valid = (inter > _F0) & (union > _F0)
    iou = np.where(valid, inter / np.where(valid, union, _F1), _F0)
    return iou, valid
