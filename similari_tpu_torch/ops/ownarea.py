"""Exclusively-owned box areas for occlusion gating (mirrors
`similari_tpu/ops/ownarea.py`).

For every box of a detection set, the share of its area that no other box
covers, `max(area_i - |B_i ∩ ∪_{j≠i} B_j|, 0) / area_i` clamped to
[0, 1].  The covered area is expanded by inclusion-exclusion,

    |B_i ∩ ∪_j B_j| = Σ_j |B_i∩B_j| − Σ_{j<k} |B_i∩B_j∩B_k| + …

where each term is the area of an intersection of convex quads by the
Green's-theorem boundary integral (`intersection_area_k`, the K-quad form
of `geometry.quad_intersection_area`).  The pairwise term covers every
box; the higher terms, up to `order` quads, only each box's `neighbors`
heaviest overlaps.  The result is exact while no point of a box lies under
more than `order - 1` of its top neighbours, and otherwise obeys the
Bonferroni brackets (see the JAX module).

Boxes take an optional leading scene axis: [S?, D, 5] -> [S?, D].
"""

from __future__ import annotations

import torch

from . import geometry as geo

EPS = 1e-5


def intersection_area_k(quads: torch.Tensor) -> torch.Tensor:
    """Area of the intersection of K convex quads: [..., K, 4, 2] -> [...].

    Each quad's edges are Liang-Barsky clipped to the other quads'
    halfplanes.  Quads are wound as `geometry.box_vertices` winds them
    (inside = cross <= 0).  A segment lying exactly on another quad's
    boundary is kept only when that quad has a higher stack index, or when
    traversed in the opposite direction, so a shared boundary counts once
    and the two traversals of a touching edge cancel.
    """
    k = quads.shape[-3]
    total = torch.zeros(quads.shape[:-3], dtype=quads.dtype,
                        device=quads.device)
    for m in range(k):
        a_quad = quads[..., m, :, :]
        for i in range(4):
            sx = a_quad[..., i, 0]
            sy = a_quad[..., i, 1]
            dex = a_quad[..., (i + 1) % 4, 0] - sx
            dey = a_quad[..., (i + 1) % 4, 1] - sy
            t0 = torch.zeros_like(sx)
            t1 = torch.ones_like(sx)
            ok = torch.ones(sx.shape, dtype=torch.bool, device=sx.device)
            for mp in range(k):
                if mp == m:
                    continue
                b_quad = quads[..., mp, :, :]
                for h in range(4):
                    px = b_quad[..., h, 0]
                    py = b_quad[..., h, 1]
                    dx = b_quad[..., (h + 1) % 4, 0] - px
                    dy = b_quad[..., (h + 1) % 4, 1] - py
                    fa = dx * (sy - py) - dy * (sx - px)  # inside <= 0
                    fb = dx * dey - dy * dex  # along the edge
                    tt = -fa / torch.where(fb == 0.0, 1.0, fb)
                    t0 = torch.where(fb < 0.0, torch.maximum(t0, tt), t0)
                    t1 = torch.where(fb > 0.0, torch.minimum(t1, tt), t1)
                    para_out = (fb == 0.0) & (fa > 0.0)
                    if mp < m:
                        same_dir = dx * dex + dy * dey >= 0.0
                        para_out = para_out | ((fb == 0.0) & (fa == 0.0)
                                               & same_dir)
                    ok = ok & ~para_out
            p0x = sx + t0 * dex
            p0y = sy + t0 * dey
            p1x = sx + t1 * dex
            p1y = sy + t1 * dey
            contrib = p0x * p1y - p0y * p1x
            total = total + torch.where(ok & (t1 > t0), contrib, 0.0)
    return torch.abs(total) * 0.5


def _subset_area(self_q, nq, live_nbr, size):
    """Σ over neighbour tuples n_1 < … < n_size of
    |B_i ∩ B_{n_1} ∩ … ∩ B_{n_size}|.  self_q [..., D, 4, 2], nq
    [..., D, M, 4, 2], live_nbr [..., D, M]; axes [..., D, M, …, M]."""
    lead = self_q.shape[:-2]  # [..., D]
    m = nq.shape[-3]
    full = lead + (m,) * size
    members = [self_q.reshape(lead + (1,) * size + (4, 2)).expand(
        full + (4, 2))]
    live = torch.ones(full, dtype=torch.bool, device=nq.device)
    for pos in range(size):
        qshape = [1] * size
        qshape[pos] = m
        members.append(nq.reshape(lead + tuple(qshape) + (4, 2)).expand(
            full + (4, 2)))
        live = live & live_nbr.reshape(lead + tuple(qshape))
    # strictly increasing slot tuples only (each subset once)
    idx = torch.arange(m, device=nq.device)
    for pos in range(size - 1):
        a = [1] * size
        a[pos] = m
        b = [1] * size
        b[pos + 1] = m
        live = live & (idx.reshape(a) < idx.reshape(b))
    quads = torch.stack(members, dim=-3)
    area = torch.where(live, intersection_area_k(quads), 0.0)
    return area.sum(dim=tuple(range(-size, 0)))


def own_area_shares(boxes: torch.Tensor, valid: torch.Tensor,
                    order: int = 3, neighbors: int = 8) -> torch.Tensor:
    """Own-area shares of boxes [S?, D, 5] with validity [S?, D]; invalid
    rows get 1.0, the gate-neutral value."""
    d = boxes.shape[-2]
    valid = valid.bool()
    area = geo.box_area(boxes)
    # box j seen from box i's centre: every term for box i lives in box
    # i's frame, which keeps f32 exact at large scene coordinates
    rel = boxes[..., None, :, :2] - boxes[..., :, None, :2]
    rest = boxes[..., None, :, 2:].expand(rel.shape[:-1] + (3,))
    verts = geo.box_vertices(torch.cat([rel, rest], dim=-1))  # [.., D, D, 4, 2]
    self_q = geo.box_vertices(torch.cat(
        [torch.zeros_like(boxes[..., :2]), boxes[..., 2:]], dim=-1))

    eye = torch.eye(d, dtype=torch.bool, device=boxes.device)
    pair_mask = (valid[..., :, None] & valid[..., None, :] & ~eye
                 & ~geo.too_far(boxes[..., :, None, :], boxes[..., None, :, :]))
    pair = torch.where(
        pair_mask,
        geo.quad_intersection_area(self_q[..., :, None, :, :], verts), 0.0)
    covered = pair.sum(dim=-1)

    m = min(neighbors, d - 1)
    if order >= 3 and m >= 2:
        # top-M overlaps per box; the stable sort puts the lower index
        # first among equal areas, as lax.top_k does (every far pair ties
        # at 0)
        srt = torch.sort(pair, dim=-1, descending=True, stable=True)
        live_nbr = srt.values[..., :m] > 0.0
        idx = srt.indices[..., :m]
        nq = torch.take_along_dim(verts, idx[..., None, None], dim=-3)
        sign = 1.0
        for size in range(2, order):
            sign = -sign
            covered = covered + sign * _subset_area(self_q, nq, live_nbr,
                                                    size)

    own = torch.clamp(area - covered, min=0.0)
    share = torch.clamp(own / (area + EPS), 0.0, 1.0)
    return torch.where(valid, share, 1.0).to(boxes.dtype)
