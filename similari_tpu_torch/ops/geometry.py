"""Batched box geometry: vertices, radius gating, rotated intersection and
IoU (mirrors `similari_tpu/ops/geometry.py`).

Boxes are `[..., 5]` tensors (xc, yc, angle, aspect, height).  The rotated
intersection is the reference's Green's-theorem boundary integral: each
edge of one quad is clipped to the other by Liang-Barsky and contributes
cross(p(t0), p(t1)); a second pass over the other quad's edges, with the
collinear tie-break, closes the boundary.  The pair is recentred around
the midpoint of its two centres before clipping, so f32 stays exact at
large coordinates.

Each expression keeps the reference's operation order, so the values
agree with the JAX package's to rounding.  The radius-pruned top-k form
(`rotated_intersection_topk`) and the Sutherland-Hodgman polygon clip are
not ported yet (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import math

import torch

EPS = 1e-5

TOPK_NOT_PORTED = (
    "the radius-pruned top-k clip (neighbors > 0) is not ported yet: "
    "ROADMAP queue 1, item 11 (rotated_intersection_topk)")


def box_radius(boxes: torch.Tensor) -> torch.Tensor:
    """Enclosing-circle radius of boxes [..., 5]."""
    hw = boxes[..., 3] * boxes[..., 4] * 0.5
    hh = boxes[..., 4] * 0.5
    return torch.sqrt(hw * hw + hh * hh)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """w*h = aspect*height^2."""
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 4]


def box_vertices(boxes: torch.Tensor) -> torch.Tensor:
    """Rotated-rect corners [..., 4, 2], in the reference's order."""
    angle = boxes[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    hw = boxes[..., 3] * boxes[..., 4] * 0.5
    hh = boxes[..., 4] * 0.5
    r1x = -hw * c - hh * s
    r1y = -hw * s + hh * c
    r2x = hw * c - hh * s
    r2y = hw * s + hh * c
    x = boxes[..., 0]
    y = boxes[..., 1]
    return torch.stack([
        torch.stack([x + r1x, y + r1y], dim=-1),
        torch.stack([x + r2x, y + r2y], dim=-1),
        torch.stack([x - r1x, y - r1y], dim=-1),
        torch.stack([x - r2x, y - r2y], dim=-1),
    ], dim=-2)


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [0, 2pi)."""
    pix2 = 2.0 * math.pi
    a = a - torch.floor(a / pix2) * pix2
    return torch.where(a < 0.0, a + pix2, a)


def center_distance2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    return dx * dx + dy * dy


def too_far(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circle-radius prune; broadcasts over batch dims."""
    md = box_radius(a) + box_radius(b)
    return center_distance2(a, b) > md * md


def dist_in_2r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Centre distance over the sum of the two radii."""
    rd = box_radius(a) + box_radius(b)
    return torch.sqrt(center_distance2(a, b)) / torch.sqrt(rd * rd + EPS)


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _boundary_integral(A: torch.Tensor, B: torch.Tensor,
                       tie_pass: bool) -> torch.Tensor:
    """Sum of cross(p0, p1) over A's edges clipped to convex quad B.

    A, B: [..., 4, 2], wound alike (inside = cross <= 0).  A segment lying
    exactly on a halfplane boundary belongs to the closed clip in the first
    pass and, in the tie pass, only when traversed in the opposite
    direction: shared edges of identical boxes count once, and the two
    opposite traversals of a touching edge cancel.
    """
    total = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    for i in range(4):
        sx = A[..., i, 0]
        sy = A[..., i, 1]
        ex = A[..., (i + 1) % 4, 0]
        ey = A[..., (i + 1) % 4, 1]
        dex = ex - sx
        dey = ey - sy
        t0 = torch.zeros_like(sx)
        t1 = torch.ones_like(sx)
        ok = torch.ones(sx.shape, dtype=torch.bool, device=sx.device)
        for h in range(4):
            px = B[..., h, 0]
            py = B[..., h, 1]
            dx = B[..., (h + 1) % 4, 0] - px
            dy = B[..., (h + 1) % 4, 1] - py
            a = _cross2(dx, dy, sx - px, sy - py)  # f(s); inside = a <= 0
            b = _cross2(dx, dy, dex, dey)  # df along the edge
            tt = -a / torch.where(b == 0.0, 1.0, b)
            t0 = torch.where(b < 0.0, torch.maximum(t0, tt), t0)
            t1 = torch.where(b > 0.0, torch.minimum(t1, tt), t1)
            para_out = (b == 0.0) & (a > 0.0)
            if tie_pass:
                same_dir = dx * dex + dy * dey >= 0.0
                para_out = para_out | ((b == 0.0) & (a == 0.0) & same_dir)
            ok = ok & ~para_out
        p0x = sx + t0 * dex
        p0y = sy + t0 * dey
        p1x = sx + t1 * dex
        p1y = sy + t1 * dey
        contrib = _cross2(p0x, p0y, p1x, p1y)
        total = total + torch.where(ok & (t1 > t0), contrib, 0.0)
    return total


def quad_intersection_area(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Intersection area of two convex quads [..., 4, 2] -> [...]."""
    s = (_boundary_integral(va, vb, tie_pass=False)
         + _boundary_integral(vb, va, tie_pass=True))
    return torch.abs(s) * 0.5


def rotated_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection area of boxes [..., 5] (broadcast); too_far pairs are
    exactly 0."""
    a, b = torch.broadcast_tensors(a, b)
    mid = 0.5 * (a[..., :2] + b[..., :2])
    ac = torch.cat([a[..., :2] - mid, a[..., 2:]], dim=-1)
    bc = torch.cat([b[..., :2] - mid, b[..., 2:]], dim=-1)
    area = quad_intersection_area(box_vertices(ac), box_vertices(bc))
    return torch.where(too_far(a, b), 0.0, area)


def aligned_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned intersection of (xc, yc, _, aspect, h) boxes [..., 5];
    only valid when both angles are 0 (callers gate on a static flag)."""
    aw = a[..., 3] * a[..., 4]
    bw = b[..., 3] * b[..., 4]
    iw = (torch.minimum(a[..., 0] + aw * 0.5, b[..., 0] + bw * 0.5)
          - torch.maximum(a[..., 0] - aw * 0.5, b[..., 0] - bw * 0.5))
    ih = (torch.minimum(a[..., 1] + a[..., 4] * 0.5,
                        b[..., 1] + b[..., 4] * 0.5)
          - torch.maximum(a[..., 1] - a[..., 4] * 0.5,
                          b[..., 1] - b[..., 4] * 0.5))
    return torch.where((iw > 0.0) & (ih > 0.0), iw * ih, 0.0)


def universal_iou(a: torch.Tensor, b: torch.Tensor, oriented: bool = True):
    """(iou, valid); valid is False where the intersection is 0.  The
    `union > 0` guard keeps degenerate zero-area boxes at 0: roundoff can
    leave the intersection just above a ~0 union."""
    inter = rotated_intersection(a, b) if oriented else aligned_intersection(a, b)
    union = box_area(a) + box_area(b) - inter
    valid = (inter > 0.0) & (union > 0.0)
    iou = torch.where(valid, inter / torch.where(valid, union, 1.0), 0.0)
    return iou, valid


def universal_iou_matrix(a: torch.Tensor, b: torch.Tensor,
                         oriented: bool = True, neighbors: int = 0):
    """Pairwise IoU a[..., D, 5] x b[..., T, 5] -> (iou[..., D, T],
    valid[..., D, T]); leading dims (a scene axis) broadcast."""
    if oriented and 0 < neighbors < b.shape[-2]:
        raise NotImplementedError(TOPK_NOT_PORTED)
    return universal_iou(a[..., :, None, :], b[..., None, :, :], oriented)
