"""Oriented SORT in plain PyTorch, float64, on the CPU: a test oracle for
the port's oriented IoU matching, written from the reference project's
semantics and importing nothing of the port.

The positional weight is the reference's oriented IoU (`bbox.rs:476-535`,
as `reference_sort.py::poly_iou` follows it): pairs whose enclosing
circles do not meet score 0 (`too_far`); every other pair is clipped by
Sutherland-Hodgman (`clipping.rs:12-91`: the subject's corners clipped to
each edge of the other box in turn) and the area of what is left taken by
the shoelace formula, IoU = area / union (0 where the union is not
positive).  Only the in-radius pairs are clipped, as tensor code over all
of them at once.  That is independent of the port's Liang-Barsky boundary
integral.

The tracker keeps the semantics of `perfbench/reference/tracker.py`
(SORT): the Kalman box filter per slot, IoU x clamped confidence on
compatible (active, idle at most `max_idle_epochs`) tracks, the exact
voting LP by scipy's Hungarian (a row takes a track worth at least the
threshold or a new track worth the threshold), the r-th new row in the
r-th free slot, tracks idle past `max_idle_epochs` retired at the top of
a frame (`recycle_idle`), and a frame whose new tracks do not fit writes
nothing.  Where the program's assignment differs from the optimum, `step`
takes it only when its total lies within the auction's guarantee of the
optimum, and says so.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

F64 = torch.float64
# a pair the program scored in float32 may sit this far on the other side
# of the threshold (measured: the port's float32 rotated IoU lies within
# 8.9e-6 of this clip on the oriented cell's boxes; see
# perfbench/reference/oriented.py)
PAIR_SLACK = 1e-4
# the forward auction ends eps-optimal: within (rows bidding) x eps of the
# optimum, eps = span / max(4096, 64 D)
AUCTION_SLACK = 1.0
VERTS = 16  # vertex slots of a clipped polygon


def box_vertices(box: torch.Tensor) -> torch.Tensor:
    """Corners [N, 4, 2] of boxes [N, 5] (xc, yc, angle, aspect, height),
    in the reference's order (`bbox.rs:287-330`)."""
    c, s = torch.cos(box[:, 2]), torch.sin(box[:, 2])
    hw = box[:, 3] * box[:, 4] * 0.5
    hh = box[:, 4] * 0.5
    r1 = torch.stack([-hw * c - hh * s, -hw * s + hh * c], -1)
    r2 = torch.stack([hw * c - hh * s, hw * s + hh * c], -1)
    x = box[:, :2]
    return torch.stack([x + r1, x + r2, x - r1, x - r2], 1)


def _inside(px, py, a, b):
    """Clockwise corners: inside the edge a -> b where the cross product is
    <= 0."""
    return ((b[:, None, 0] - a[:, None, 0]) * (py - a[:, None, 1])
            - (b[:, None, 1] - a[:, None, 1]) * (px - a[:, None, 0])) <= 0


def _crossing(x1, y1, x2, y2, a, b):
    """Where the segment p1 -> p2 meets the line a -> b."""
    ax, ay = a[:, None, 0], a[:, None, 1]
    bx, by = b[:, None, 0], b[:, None, 1]
    dcx, dcy = ax - bx, ay - by
    dpx, dpy = x1 - x2, y1 - y2
    n1 = ax * by - ay * bx
    n2 = x1 * y2 - y1 * x2
    n3 = 1.0 / (dcx * dpy - dcy * dpx)
    return (n1 * dpx - n2 * dcx) * n3, (n1 * dpy - n2 * dcy) * n3


def clip_area(subject: torch.Tensor, clip: torch.Tensor) -> torch.Tensor:
    """Area [N] of quads subject [N, 4, 2] clipped to quads clip [N, 4, 2]
    (Sutherland-Hodgman, then the shoelace formula)."""
    n = subject.shape[0]
    idx = torch.arange(VERTS)
    px = torch.zeros((n, VERTS), dtype=subject.dtype)
    py = torch.zeros_like(px)
    px[:, :4], py[:, :4] = subject[..., 0], subject[..., 1]
    count = torch.full((n,), 4)
    for e in range(4):
        a, b = clip[:, e - 1], clip[:, e]
        live = idx[None] < count[:, None]
        prev = torch.where(idx[None] == 0, count[:, None] - 1, idx[None] - 1)
        prev = prev.clamp(min=0)
        qx, qy = px.gather(1, prev), py.gather(1, prev)
        in2, in1 = _inside(px, py, a, b), _inside(qx, qy, a, b)
        cx, cy = _crossing(qx, qy, px, py, a, b)
        emit = torch.stack([live & (in2 != in1), live & in2], -1).reshape(
            n, 2 * VERTS)
        vx = torch.stack([cx, px], -1).reshape(n, 2 * VERTS)
        vy = torch.stack([cy, py], -1).reshape(n, 2 * VERTS)
        pos = torch.where(emit, torch.cumsum(emit.long(), 1) - 1, VERTS)
        pos = pos.clamp(max=VERTS)
        px = torch.zeros((n, VERTS + 1), dtype=subject.dtype)
        py = torch.zeros_like(px)
        px.scatter_(1, pos, torch.where(emit, vx, 0.0))
        py.scatter_(1, pos, torch.where(emit, vy, 0.0))
        px, py = px[:, :VERTS], py[:, :VERTS]
        count = emit.sum(1).clamp(max=VERTS)
    live = idx[None] < count[:, None]
    nxt = torch.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
    term = px * py.gather(1, nxt) - px.gather(1, nxt) * py
    return torch.where(live, term, 0.0).sum(1).abs() / 2.0


def rotated_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU [n, m] of boxes a [n, 5] and b [m, 5], float64: too-far pairs 0,
    the rest clipped."""
    a, b = a.to(F64), b.to(F64)
    ra = torch.hypot(a[:, 3] * a[:, 4] / 2.0, a[:, 4] / 2.0)
    rb = torch.hypot(b[:, 3] * b[:, 4] / 2.0, b[:, 4] / 2.0)
    md = ra[:, None] + rb[None]
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2 + (a[:, None, 1] - b[None, :, 1]) ** 2
    i, j = torch.nonzero(~(d2 > md * md), as_tuple=True)
    iou = torch.zeros((len(a), len(b)), dtype=F64)
    if len(i):
        inter = clip_area(box_vertices(a[i]), box_vertices(b[j]))
        union = a[i, 3] * a[i, 4] * a[i, 4] + b[j, 3] * b[j, 4] * b[j, 4] - inter
        iou[i, j] = torch.where(union > 0, inter / union, 0.0)
    return iou


# -- the Kalman box filter (per slot, diagonal, as the port's) ------------

def _box_var(k, cnst, h, weight):
    s = (k * weight) * h
    out = torch.stack([s, s, s, torch.full_like(s, cnst), s], -1)
    return out * out


def kf_initiate(z, pw, vw):
    zero = torch.zeros_like(z)
    return [z.clone(), zero, _box_var(2.0, 1e-2, z[:, 4], pw), zero.clone(),
            _box_var(10.0, 1e-5, z[:, 4], vw)]


def kf_predict(kf, pw, vw):
    mp, mv, cpp, cpv, cvv = kf
    qp = _box_var(1.0, 1e-2, mp[:, 4], pw)
    qv = _box_var(1.0, 1e-5, mp[:, 4], vw)
    return [mp + mv, mv, cpp + 2.0 * cpv + cvv + qp, cpv + cvv, cvv + qv]


def kf_update(kf, z, pw):
    mp, mv, cpp, cpv, cvv = kf
    S = cpp + _box_var(1.0, 1e-1, mp[:, 4], pw)
    nu = z - mp
    gp, gv = cpp / S, cpv / S
    return [mp + nu * gp, mv + nu * gv, cpp - cpp * gp, cpv - cpp * gv,
            cvv - cpv * gv]


# -- the voting LP ----------------------------------------------------------

def optimal_matches(W: torch.Tensor, thr: float) -> Dict[int, int]:
    """{row: track} of the exact voting LP on weights W [D, T]."""
    w = W.numpy()
    rows = np.flatnonzero((w >= thr).any(1))
    cols = np.flatnonzero((w >= thr).any(0))
    if not len(rows):
        return {}
    sub = w[np.ix_(rows, cols)]
    r, c = linear_sum_assignment(np.where(sub >= thr, sub - thr, 0.0),
                                 maximize=True)
    return {int(rows[i]): int(cols[j]) for i, j in zip(r, c)
            if sub[i, j] >= thr}


def _lp_total(W, thr, n_open, matches):
    return (sum(float(W[r, c]) for r, c in matches.items())
            + thr * (n_open - len(matches)))


class OrientedSort:
    """One scene of oriented SORT with IoU: `capacity` slots, rows padded
    to `dpad` (the auction's eps depends on it)."""

    def __init__(self, capacity: int, dpad: int, iou_threshold: float = 0.3,
                 min_confidence: float = 0.05, max_idle_epochs: int = 5,
                 recycle_idle: bool = True, position_weight: float = 1 / 20,
                 velocity_weight: float = 1 / 160):
        t = capacity
        self.t, self.dpad = t, dpad
        self.thr, self.min_conf = iou_threshold, min_confidence
        self.max_idle, self.recycle = max_idle_epochs, recycle_idle
        self.pw, self.vw = position_weight, velocity_weight
        self.active = torch.zeros(t, dtype=torch.bool)
        self.last_epoch = torch.zeros(t, dtype=torch.int64)
        self.length = torch.zeros(t, dtype=torch.int64)
        self.track_id = torch.zeros(t, dtype=torch.int64)
        self.kf = [torch.zeros((t, 5), dtype=F64) for _ in range(5)]
        self.next_id = 0

    def _program_or_optimum(self, P, ok, n_open, ref, prog):
        """(matches, tie, refused rows): the program's matches where they
        are as good as the optimum up to the auction's guarantee."""
        if prog == ref:
            return ref, False, 0
        good = len(set(prog.values())) == len(prog) and all(
            bool(ok[r, c]) and float(P[r, c]) >= self.thr - PAIR_SLACK
            for r, c in prog.items())
        if good:
            W = torch.where(ok, P, 0.0)
            span = max(float(W.max()) if W.numel() else 0.0, self.thr)
            eps = span / max(4096.0, 64.0 * self.dpad)
            slack = n_open * (AUCTION_SLACK * eps + PAIR_SLACK)
            if (_lp_total(W, self.thr, n_open, prog)
                    >= _lp_total(W, self.thr, n_open, ref) - slack):
                return prog, True, 0
        differ = {r for r in set(ref) | set(prog) if ref.get(r) != prog.get(r)}
        return ref, False, len(differ)

    def step(self, box, conf, valid, epoch: int,
             prog: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """One frame of box [D, 5], conf [D], valid [D]; `prog` (the
        program's slot and is_new of this frame) lets the step take the
        program's assignment where it is an equal optimum.  Returns ids,
        slots, is_new, pred [D, 5], tie and refused."""
        box = torch.as_tensor(box).to(F64)
        conf = torch.as_tensor(conf).to(F64)
        valid = torch.as_tensor(valid).bool()
        d, t = box.shape[0], self.t
        if self.recycle:
            self.active &= epoch - self.last_epoch <= self.max_idle
        compat = self.active & (epoch - self.last_epoch <= self.max_idle)
        rows, cols = torch.nonzero(valid)[:, 0], torch.nonzero(compat)[:, 0]
        P = torch.zeros((d, t), dtype=F64)
        if len(rows) and len(cols):
            iou = rotated_iou(box[rows], self.kf[0][cols])
            P[rows[:, None], cols[None]] = iou * torch.clamp(
                conf[rows], min=self.min_conf)[:, None]
        raw_ok = (P > 0) & valid[:, None] & self.active[None]
        ref = optimal_matches(torch.where(raw_ok & (P >= self.thr), P, 0.0),
                              self.thr)
        tie, refused = False, 0
        if prog is not None:
            pos = valid & ~torch.as_tensor(prog["is_new"]).bool()
            slots = torch.as_tensor(prog["slots"])
            pmatch = {int(r): int(slots[r]) for r in torch.nonzero(pos)[:, 0]}
            ref, tie, refused = self._program_or_optimum(
                P, raw_ok, int(valid.sum()), ref, pmatch)

        matched = torch.zeros(d, dtype=torch.bool)
        tgt = torch.zeros(d, dtype=torch.int64)
        for r, c in ref.items():
            matched[r], tgt[r] = True, c
        is_new = valid & ~matched
        new_rank = torch.cumsum(is_new.long(), 0) - 1
        n_new = int(is_new.sum())
        free = torch.nonzero(~self.active)[:, 0]
        overflow = n_new > len(free)
        nth = (free[new_rank.clamp(0, max(len(free) - 1, 0))]
               if len(free) else torch.full((d,), t - 1))
        nth = torch.where(new_rank < len(free), nth, t - 1)
        slot = torch.where(matched, tgt, nth)

        init = kf_initiate(box, self.pw, self.vw)
        prev = [torch.where(matched[:, None], c[slot], i)
                for c, i in zip(self.kf, init)]
        st = kf_update(kf_predict(prev, self.pw, self.vw), box, self.pw)
        new_length = torch.where(matched, self.length[slot] + 1, 1)
        ids = torch.where(matched, self.track_id[slot],
                          self.next_id + new_rank + 1)
        if not overflow:
            w = torch.nonzero(valid)[:, 0]
            ws = slot[w]
            for c, v in zip(self.kf, st):
                c[ws] = v[w]
            self.active[ws] = True
            self.last_epoch[ws] = epoch
            self.length[ws] = new_length[w]
            self.track_id[ws] = ids[w]
        self.next_id += n_new
        return dict(ids=ids, slots=slot, is_new=is_new, pred=st[0], tie=tie,
                    refused=refused)

    def state(self) -> Dict[str, torch.Tensor]:
        return dict(active=self.active, last_epoch=self.last_epoch,
                    length=self.length, track_id=self.track_id,
                    mean_pos=self.kf[0], mean_vel=self.kf[1], cpp=self.kf[2],
                    cpv=self.kf[3], cvv=self.kf[4])
