"""Plain SORT on rotated boxes, one scene at a time, in float64: the
oriented cells' reference, and the comparison that decides their
`correct`.

`OrientedTracker` is `tracker.Tracker` with the positional weight of the
reference project's oriented SORT (`bbox.rs:476-535`): pairs whose
enclosing circles do not meet score 0 (`too_far`); every other pair is
clipped by Sutherland-Hodgman (each box's corners in the reference's
order, the subject clipped to each edge of the other box in turn) and the
intersection's area taken by the shoelace formula; IoU is that area over
the union, 0 where the union is not positive.  That is independent of the
program's Liang-Barsky boundary integral.  The clip is tensor code over
the in-radius pairs of a frame (plain PyTorch, float64, on the CPU), a
frozen copy of `tests/reference_oriented_torch.py`'s.  Kalman, slots,
`recycle_idle` and the exact assignment are `tracker.Tracker`'s.

`compare_all` is `check.compare_all` with this tracker in the
reference's place; the numbers and limits are `check`'s.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check
from .check import KF_FIELDS, Readings  # noqa: F401  (the drivers read them)
from .tracker import AUCTION_SLACK, Settings, Tracker, lp_total

# A pair the program scored in float32 may sit this far on the other side
# of the threshold.  Measured on the oriented cell's boxes (obb500_s256's
# traffic, 4 scenes, each frame's detections against the last frame's, 64
# frames, 251,201 overlapping pairs): the program's float32 rotated IoU
# (the clip's plain version, the kernel's arithmetic) lies at most
# 8.9e-6 from this float64 clip, its IoU x confidence at most 8.2e-6 from
# the float64 product.  The slack keeps over 10 times that for the tail a
# whole window's pairs may reach; `tracker.PAIR_SLACK` keeps 30 times the
# aligned IoU's 3e-6.
ORIENTED_PAIR_SLACK = 1e-4
_VERTS = 16  # vertex slots of a clipped polygon (a quad clipped by a quad
# has at most 8; one edge's pass writes up to 2 a vertex before compaction)


def settings(config: Dict) -> Settings:
    """The tracker settings of an oriented SORT configuration."""
    s = config["settings"]
    if config["tracker"] != "sort" or s.get("method") != "iou":
        raise ValueError("the oriented reference covers SORT with IoU")
    keep = {f.name for f in dataclasses.fields(Settings)} - {
        "tracker", "min_confidence"}
    return Settings(tracker="sort", min_confidence=s["min_confidence"],
                    **{k: v for k, v in s.items() if k in keep})


def box_vertices(box: torch.Tensor) -> torch.Tensor:
    """Corners [N, 4, 2] of boxes [N, 5] (xc, yc, angle, aspect, height) in
    the reference's order (`bbox.rs:287-330`)."""
    c, s = torch.cos(box[:, 2]), torch.sin(box[:, 2])
    hw = box[:, 3] * box[:, 4] * 0.5
    hh = box[:, 4] * 0.5
    r1 = torch.stack([-hw * c - hh * s, -hw * s + hh * c], -1)
    r2 = torch.stack([hw * c - hh * s, hw * s + hh * c], -1)
    x = box[:, :2]
    return torch.stack([x + r1, x + r2, x - r1, x - r2], 1)


def _inside(px, py, a, b):
    """Clockwise corners: a point is inside the edge a -> b where the cross
    product is <= 0 (`clipping.rs:12-15`)."""
    return ((b[:, None, 0] - a[:, None, 0]) * (py - a[:, None, 1])
            - (b[:, None, 1] - a[:, None, 1]) * (px - a[:, None, 0])) <= 0


def _crossing(x1, y1, x2, y2, a, b):
    """Where the segment p1 -> p2 meets the line a -> b
    (`clipping.rs`'s intersection, in its operation order)."""
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
    by Sutherland-Hodgman, each polygon held in `_VERTS` slots with its
    vertex count."""
    n_pairs = subject.shape[0]
    idx = torch.arange(_VERTS)
    px = torch.zeros((n_pairs, _VERTS), dtype=subject.dtype)
    py = torch.zeros_like(px)
    px[:, :4], py[:, :4] = subject[..., 0], subject[..., 1]
    count = torch.full((n_pairs,), 4)
    for e in range(4):
        a, b = clip[:, e - 1], clip[:, e]  # edges 3-0, 0-1, 1-2, 2-3
        live = idx[None] < count[:, None]
        prev = torch.where(idx[None] == 0, count[:, None] - 1, idx[None] - 1)
        prev = prev.clamp(min=0)
        qx, qy = px.gather(1, prev), py.gather(1, prev)
        in2, in1 = _inside(px, py, a, b), _inside(qx, qy, a, b)
        cx, cy = _crossing(qx, qy, px, py, a, b)
        # each vertex writes its crossing (if the edge is crossed), then
        # itself (if inside), in the reference's order
        emit = torch.stack([live & (in2 != in1), live & in2], -1).reshape(
            n_pairs, 2 * _VERTS)
        vx = torch.stack([cx, px], -1).reshape(n_pairs, 2 * _VERTS)
        vy = torch.stack([cy, py], -1).reshape(n_pairs, 2 * _VERTS)
        pos = torch.where(emit, torch.cumsum(emit.long(), 1) - 1, _VERTS)
        pos = pos.clamp(max=_VERTS)
        px = torch.zeros((n_pairs, _VERTS + 1), dtype=subject.dtype)
        py = torch.zeros_like(px)
        px.scatter_(1, pos, torch.where(emit, vx, 0.0))
        py.scatter_(1, pos, torch.where(emit, vy, 0.0))
        px, py = px[:, :_VERTS], py[:, :_VERTS]
        count = emit.sum(1).clamp(max=_VERTS)
    live = idx[None] < count[:, None]
    nxt = torch.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
    term = px * py.gather(1, nxt) - px.gather(1, nxt) * py
    return torch.where(live, term, 0.0).sum(1).abs() / 2.0


def rotated_iou(a: np.ndarray, b: np.ndarray):
    """(iou, overlaps) [n, m] of boxes a [n, 5] and b [m, 5], float64:
    too-far pairs 0, the rest clipped."""
    ta = torch.as_tensor(np.asarray(a, np.float64))
    tb = torch.as_tensor(np.asarray(b, np.float64))
    ra = torch.hypot(ta[:, 3] * ta[:, 4] / 2.0, ta[:, 4] / 2.0)
    rb = torch.hypot(tb[:, 3] * tb[:, 4] / 2.0, tb[:, 4] / 2.0)
    md = ra[:, None] + rb[None]
    d2 = ((ta[:, None, 0] - tb[None, :, 0]) ** 2
          + (ta[:, None, 1] - tb[None, :, 1]) ** 2)
    i, j = torch.nonzero(~(d2 > md * md), as_tuple=True)
    iou = torch.zeros((len(ta), len(tb)), dtype=torch.float64)
    if len(i):
        inter = clip_area(box_vertices(ta[i]), box_vertices(tb[j]))
        area_a = ta[i, 3] * ta[i, 4] * ta[i, 4]
        area_b = tb[j, 3] * tb[j, 4] * tb[j, 4]
        union = area_a + area_b - inter
        iou[i, j] = torch.where(union > 0, inter / union, 0.0)
    iou = iou.numpy()
    return iou, iou > 0


class OrientedTracker(Tracker):
    """`tracker.Tracker` with the rotated IoU (SORT only)."""

    def _positional(self, box, conf, valid, compat):
        d, t = box.shape[0], self.t
        m, ok = np.zeros((d, t)), np.zeros((d, t), bool)
        rows, cols = np.flatnonzero(valid), np.flatnonzero(compat)
        if len(rows) and len(cols):
            iou, v = rotated_iou(box[rows], self.kf[0][cols])
            conf = np.maximum(conf[rows], self.s.min_confidence)
            m[np.ix_(rows, cols)] = iou * conf[:, None]
            ok[np.ix_(rows, cols)] = v
        return m, ok

    def _check_program(self, P, pvalid, thr, open_rows, open_cols, ref,
                       prog):
        """`Tracker._check_program` with the rotated IoU's pair slack."""
        if prog == ref:
            return ref, False, 0
        ok = len(set(prog.values())) == len(prog)
        for r, c in prog.items():
            ok &= (r in open_rows and c in open_cols and pvalid[r, c]
                   and P[r, c] >= thr - ORIENTED_PAIR_SLACK)
        if ok:
            W = np.where(pvalid, P, 0.0)
            span = max(W.max(initial=0.0), thr)
            eps = span / max(4096.0, 64.0 * self.dpad)
            slack = len(open_rows) * (AUCTION_SLACK * eps
                                      + ORIENTED_PAIR_SLACK)
            if (lp_total(W, thr, open_rows, prog)
                    >= lp_total(W, thr, open_rows, ref) - slack):
                return prog, True, 0
        differ = {r for r in set(ref) | set(prog) if ref.get(r) != prog.get(r)}
        return ref, False, len(differ)


def compare_scene(config: Dict, dpad: int, frames: List[Dict[str, np.ndarray]],
                  prog: Dict[str, np.ndarray],
                  prog_state: Optional[Dict[str, np.ndarray]]) -> Readings:
    """`check.compare_scene` for SORT against `OrientedTracker`."""
    ref = OrientedTracker(settings(config), config["capacity"], dpad)
    out = Readings()
    for i, inp in enumerate(frames):
        valid = inp["valid"].astype(bool)
        p = {"slots": prog["slots"][i], "is_new": prog["is_new"][i].astype(bool),
             "vt": np.zeros_like(prog["slots"][i])}
        r = ref.step(inp, i + 1, p)
        out.frames += 1
        out.rows += int(valid.sum())
        out.ties += int(r.tie)
        bad = (prog["ids"][i] != r.ids) | (p["slots"] != r.slots) | \
            (p["is_new"] != r.is_new)
        n_bad = int((bad & valid).sum())
        out._kf("pred_box", prog["pred"][i][valid], r.pred[valid])
        if n_bad or r.refused:
            out.mismatches += max(n_bad, r.refused)
            out.detail = check._detail(ref, i, bad & valid, prog, r)
            return out
    if prog_state is not None:
        check._compare_state(out, ref.state(), prog_state, False)
    return out


def _worker(conn) -> None:
    torch.set_num_threads(1)
    conn.send(compare_scene(*conn.recv()))
    conn.close()


def compare_all(tasks: List[tuple]) -> Readings:
    """`compare_scene` over (config, dpad, frames, prog, state) tasks, one
    spawned process each, as `check.compare_all`.  Every process starts
    (and imports PyTorch) before any is sent its task, so the starts
    overlap."""
    total = Readings()
    if len(tasks) == 1:
        total.merge(compare_scene(*tasks[0]))
        return total
    cpus = os.cpu_count() or 1
    keep = os.environ.get("OPENBLAS_NUM_THREADS")
    os.environ["OPENBLAS_NUM_THREADS"] = str(max(1, cpus // len(tasks)))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    try:
        for _ in tasks:
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(there,))
            proc.start()
            there.close()
            procs.append((proc, here))
    finally:
        if keep is None:
            os.environ.pop("OPENBLAS_NUM_THREADS")
        else:
            os.environ["OPENBLAS_NUM_THREADS"] = keep
    try:
        for (_, here), task in zip(procs, tasks):
            here.send(task)
        for proc, here in procs:
            total.merge(here.recv())
    finally:
        for proc, here in procs:
            here.close()
            proc.join()
    return total
