"""Host polygon clipping utilities + exclusively-owned areas (a NumPy copy
of `similari_tpu/utils/clipping.py`, the f64 oracle).

`sutherland_hodgman_clip` / `intersection_area` mirror the reference Python
functions (`src/utils/clipping/clipping_py.rs:28-46`); the
general dynamic-vertex clip here matches `clipping.rs:40-91` in f64 numpy.

`exclusively_owned_areas*` mirror `clipping/bbox_own_areas.rs:8-46`: the area
of each box minus every overlapping neighbor.  The reference uses general
polygon boolean difference (geo crate); convex boxes let us compute the same
value by inclusion–exclusion over neighbor subsets — intersections of convex
polygons stay convex, so each term is a chain of Sutherland–Hodgman clips.
Subsets are expanded only while their running intersection is non-empty, which
keeps the expansion near-linear for realistic occlusion patterns (a hard cap
guards against adversarial stacks).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .bbox import Polygon, Universal2DBox

EPS = 1e-5


def _verts(box: Universal2DBox) -> np.ndarray:
    return np.asarray(box.get_vertices().get_points(), np.float64)


def _is_inside(q, p1, p2) -> bool:
    return (p2[0] - p1[0]) * (q[1] - p1[1]) - (p2[1] - p1[1]) * (q[0] - p1[0]) <= 0.0


def _intersection_pt(cp1, cp2, s, e):
    dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
    dp = (s[0] - e[0], s[1] - e[1])
    n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
    n2 = s[0] * e[1] - s[1] * e[0]
    n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
    return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)


def clip_polygons(subject: np.ndarray, clip: np.ndarray) -> List[tuple]:
    """General SH clip over vertex lists (host, f64), `clipping.rs:40-91`."""
    final = [tuple(p) for p in subject]
    cp = [tuple(p) for p in clip]
    for i in range(len(cp)):
        nxt = final
        final = []
        c1 = cp[i - 1]
        c2 = cp[i]
        for j in range(len(nxt)):
            s = nxt[j - 1]
            e = nxt[j]
            if _is_inside(e, c1, c2):
                if not _is_inside(s, c1, c2):
                    final.append(_intersection_pt(s, e, c1, c2))
                final.append(e)
            elif _is_inside(s, c1, c2):
                final.append(_intersection_pt(s, e, c1, c2))
    return final


def _poly_area(points: Sequence[tuple]) -> float:
    n = len(points)
    if n < 3:
        return 0.0
    s = 0.0
    for i in range(n):
        x1, y1 = points[i]
        x2, y2 = points[(i + 1) % n]
        s += x1 * y2 - x2 * y1
    return abs(s) * 0.5


def sutherland_hodgman_clip(
    subject: Universal2DBox, clipping: Universal2DBox
) -> Polygon:
    """API parity with the reference `sutherland_hodgman_clip` function."""
    return Polygon(clip_polygons(_verts(subject), _verts(clipping)))


def intersection_area(subject: Universal2DBox, clipping: Universal2DBox) -> float:
    return sutherland_hodgman_clip(subject, clipping).area()


def exclusively_owned_areas(
    boxes: Sequence[Universal2DBox], max_terms: int = 4096
) -> List[float]:
    """Area of each box not covered by any other box, `bbox_own_areas.rs:8-34`.

    own_i = area_i - |B_i ∩ (∪_j B_j)|, with the union expanded by
    inclusion–exclusion over neighbor subsets (each term convex).
    """
    n = len(boxes)
    verts = [_verts(b) for b in boxes]
    neighbors: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if not Universal2DBox.too_far(boxes[i], boxes[j]):
                neighbors[i].append(j)
                neighbors[j].append(i)

    out = []
    for i in range(n):
        base = [tuple(p) for p in verts[i]]
        # frontier of (last_neighbor_index, polygon, sign)
        covered = 0.0
        frontier = [(-1, base, -1.0)]
        terms = 0
        while frontier and terms < max_terms:
            new_frontier = []
            for last, poly, sign in frontier:
                for jj in neighbors[i]:
                    if jj <= last:
                        continue
                    inter = clip_polygons(np.asarray(poly), verts[jj])
                    a = _poly_area(inter)
                    if a <= 0.0:
                        continue
                    covered += -sign * a  # signs alternate: +|Bi∩Bj|, -|..∩..|
                    new_frontier.append((jj, inter, -sign))
                    terms += 1
            frontier = new_frontier
        out.append(max(_poly_area(base) - covered, 0.0))
    return out


def exclusively_owned_areas_normalized_shares(
    boxes: Sequence[Universal2DBox],
    own_areas: Optional[Sequence[float]] = None,
) -> List[float]:
    """share_i = own_area_i / area_i clamped to 1.0, `bbox_own_areas.rs:36-46`."""
    if own_areas is None:
        own_areas = exclusively_owned_areas(boxes)
    return [
        min(float(a) / (b.area() + EPS), 1.0) for a, b in zip(own_areas, boxes)
    ]
