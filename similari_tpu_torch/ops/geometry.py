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
(`rotated_intersection_topk`) clips only each row's k nearest in-radius
partners; the Sutherland-Hodgman clip (`clip_polygon_quads`) returns the
intersection polygon itself.  Both index with native gathers and scatters
where the JAX package contracts one-hot masks, so a NaN box touches no
other pair.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import count

EPS = 1e-5
MAX_VERTS = 8  # two convex quads intersect in at most 8 vertices
_NEG_BIG = -3e38  # the top-k score of a pair outside the radius prune


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


# ---------------------------------------------------------------------------
# Sutherland-Hodgman clipping on fixed 8-slot vertex buffers
# ---------------------------------------------------------------------------

def _edge_side(qx, qy, p1, p2):
    """r = cross(p2 - p1, q - p1); inside means r <= 0."""
    return (p2[..., 0] - p1[..., 0]) * (qy - p1[..., 1]) - (
        p2[..., 1] - p1[..., 1]) * (qx - p1[..., 0])


def _line_intersection(sx, sy, ex, ey, c1, c2):
    """Line(s, e) x Line(c1, c2)."""
    dcx = sx - ex
    dcy = sy - ey
    dpx = c1[..., 0] - c2[..., 0]
    dpy = c1[..., 1] - c2[..., 1]
    n1 = sx * ey - sy * ex
    n2 = c1[..., 0] * c2[..., 1] - c1[..., 1] * c2[..., 0]
    n3 = 1.0 / (dcx * dpy - dcy * dpx)
    return (n1 * dpx - n2 * dcx) * n3, (n1 * dpy - n2 * dcy) * n3


def _cyclic_take(v, i, live):
    """v[..., i] where `live` and i is a slot, else 0."""
    ok = live & (i >= 0) & (i < MAX_VERTS)
    return torch.where(ok, torch.gather(v, -1, i.clamp(0, MAX_VERTS - 1)),
                       0.0)


def _clip_halfplane(vx, vy, n, c1, c2):
    """Clip polygons (vx, vy)[..., 8] of n[...] live vertices by the edge
    c1 -> c2 ([..., 2]).

    Vertex e is emitted when inside, preceded by the crossing of edge
    (prev, e) when exactly one end is inside; the exclusive cumsum of the
    emissions gives each its slot.  A lane that emits nothing writes to a
    ninth slot that is dropped, so the inf or NaN of a parallel edge's
    intersection reaches no slot; past 8 emissions are dropped too.
    """
    idx = torch.arange(MAX_VERTS, device=vx.device)
    n = n[..., None]
    valid = idx < n
    prev = torch.where(idx == 0, n - 1, idx - 1)
    sx = _cyclic_take(vx, prev, valid)
    sy = _cyclic_take(vy, prev, valid)
    c1 = c1[..., None, :]
    c2 = c2[..., None, :]
    in_e = _edge_side(vx, vy, c1, c2) <= 0.0
    in_s = _edge_side(sx, sy, c1, c2) <= 0.0
    ix, iy = _line_intersection(sx, sy, vx, vy, c1, c2)
    emit_i = valid & (in_e ^ in_s)
    emit_e = valid & in_e
    cnt = emit_i.long() + emit_e.long()
    off = torch.cumsum(cnt, -1) - cnt
    pos_i = torch.where(emit_i, off, MAX_VERTS).clamp(max=MAX_VERTS)
    pos_e = torch.where(emit_e, off + emit_i.long(),
                        MAX_VERTS).clamp(max=MAX_VERTS)
    out = []
    for ip, v in ((ix, vx), (iy, vy)):
        o = torch.zeros(v.shape[:-1] + (MAX_VERTS + 1,), dtype=v.dtype,
                        device=v.device)
        o.scatter_(-1, pos_i, ip)
        o.scatter_(-1, pos_e, v)
        out.append(o[..., :MAX_VERTS])
    return out[0], out[1], cnt.sum(-1)


def _sh_clip_quads(subject: torch.Tensor, clip: torch.Tensor):
    """Quads [..., 4, 2] clipped by quads [..., 4, 2] -> (vx, vy)[..., 8],
    n[...]; slots past n hold 0."""
    subject, clip = torch.broadcast_tensors(subject, clip)
    pad = subject.new_zeros(subject.shape[:-2] + (MAX_VERTS - 4,))
    vx = torch.cat([subject[..., 0], pad], -1)
    vy = torch.cat([subject[..., 1], pad], -1)
    n = torch.full(subject.shape[:-2], 4, dtype=torch.long,
                   device=subject.device)
    for i in range(4):
        vx, vy, n = _clip_halfplane(vx, vy, n, clip[..., (i - 1) % 4, :],
                                    clip[..., i, :])
    return vx, vy, n


def _masked_area(vx, vy, n):
    """Unsigned shoelace area over the first n slots of [..., 8]."""
    idx = torch.arange(MAX_VERTS, device=vx.device)
    nn = n[..., None]
    valid = idx < nn
    nxt = torch.where(idx == nn - 1, 0, idx + 1)
    vxn = _cyclic_take(vx, nxt, valid)
    vyn = _cyclic_take(vy, nxt, valid)
    cross = vx * vyn - vxn * vy
    s = torch.where(valid, cross, 0.0).sum(-1)
    return torch.where(n >= 3, torch.abs(s) * 0.5, 0.0)


def _clip_area_one(subject: torch.Tensor, clip: torch.Tensor) -> torch.Tensor:
    """Intersection area of quads [..., 4, 2] from their clipped polygon:
    the cross-check of `quad_intersection_area`."""
    return _masked_area(*_sh_clip_quads(subject, clip))


def clip_polygon_quads(subject: torch.Tensor, clip: torch.Tensor):
    """Clip quads [..., 4, 2] by quads [..., 4, 2] -> (verts [..., 8, 2],
    count [...]); slots past the count hold 0."""
    vx, vy, n = _sh_clip_quads(subject, clip)
    return torch.stack([vx, vy], dim=-1), n


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
    valid[..., D, T]); leading dims (a scene axis) broadcast.  Each call
    that clips every oriented pair counts `geometry.oriented_dense`."""
    if oriented and 0 < neighbors < b.shape[-2]:
        return _universal_iou_matrix_topk(a, b, neighbors)
    if oriented:
        count("geometry.oriented_dense")
    return universal_iou(a[..., :, None, :], b[..., None, :, :], oriented)


def rotated_intersection_topk(a: torch.Tensor, b: torch.Tensor,
                              k: int) -> torch.Tensor:
    """Radius-pruned rotated intersection a[..., D, 5] x b[..., T, 5] ->
    [..., D, T]: only each row's k nearest not-`too_far` partners are
    clipped, every other pair is 0.  Exact whenever no row has more than
    k such partners.

    Partners are ranked by centre distance with a stable sort, so among
    equal distances the lower column comes first, as `jax.lax.top_k`
    orders them (`torch.topk` promises no order).  A NaN box is never a
    candidate (its comparisons are false), and the pairs are gathered and
    scattered natively, so it changes no other pair.
    """
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    d, t = a.shape[-2], b.shape[-2]
    cd2 = center_distance2(a[..., :, None, :], b[..., None, :, :])
    rd = box_radius(a)[..., :, None] + box_radius(b)[..., None, :]
    cand = cd2 <= rd * rd
    score, idx = torch.sort(torch.where(cand, -cd2, _NEG_BIG), dim=-1,
                            descending=True, stable=True)
    live = score[..., :k] > _NEG_BIG * 0.5
    idx = idx[..., :k]
    bk = torch.gather(b[..., None, :, :].expand(lead + (d, t, 5)), -2,
                      idx[..., None].expand(lead + (d, k, 5)))
    inter_k = rotated_intersection(a[..., :, None, :], bk)
    out = inter_k.new_zeros(lead + (d, t))
    return out.scatter_(-1, idx, torch.where(live, inter_k, 0.0))


def _universal_iou_matrix_topk(a: torch.Tensor, b: torch.Tensor, k: int):
    """(iou, valid) [..., D, T] on `rotated_intersection_topk`."""
    inter = rotated_intersection_topk(a, b, k)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    valid = (inter > 0.0) & (union > 0.0)
    iou = torch.where(valid, inter / torch.where(valid, union, 1.0), 0.0)
    return iou, valid


def aligned_intersection_ltwh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned intersection of LTWH boxes [..., 4]."""
    ax0, ay0 = a[..., 0], a[..., 1]
    ax1, ay1 = ax0 + a[..., 2], ay0 + a[..., 3]
    bx0, by0 = b[..., 0], b[..., 1]
    bx1, by1 = bx0 + b[..., 2], by0 + b[..., 3]
    iw = torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)
    ih = torch.minimum(ay1, by1) - torch.maximum(ay0, by0)
    return torch.where((iw > 0.0) & (ih > 0.0), iw * ih, 0.0)


def aligned_iou_ltwh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of LTWH boxes [..., 4] (the BoundingBox metric)."""
    inter = aligned_intersection_ltwh(a, b)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union
