"""Shared inputs and checks for the parity tests of the PyTorch port.

Streams are made with numpy from a seed and handed to both packages; a
JAX state crosses to the port as a dict of numpy arrays (`jax_state_dict`,
read by `similari_tpu_torch.convert`).  Nothing here imports JAX or the
port's CUDA build, so the card-only tests can use it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Boxes and Kalman state: the two packages sum and divide in the same
# order, but XLA may contract a multiply-add that PyTorch rounds twice, so
# floats are held to the tolerance the JAX package's own kernel tests use.
RTOL, ATOL = 2e-4, 1e-4
# Gallery lanes and feature history are copies of the input features.
GALLERY_TOL = 1e-5

# the four configurations of tests/test_pallas_visual.py, as keyword args
# that both packages' VisualConfig accept
VISUAL_CONFIGS = {
    "euclid_iou": dict(
        positional_kind="iou", oriented=False, assignment="auction",
        visual_kind="euclidean", visual_threshold=5.0,
        visual_minimal_track_length=2, max_idle_epochs=5),
    "cosine_gates": dict(
        positional_kind="iou", oriented=False, assignment="auction",
        visual_kind="cosine", visual_threshold=0.7,
        visual_minimal_track_length=1, visual_min_votes=2,
        visual_minimal_quality_use=0.5, visual_minimal_quality_collect=0.4,
        max_idle_epochs=5),
    "maha": dict(
        positional_kind="maha", oriented=False, assignment="auction",
        visual_kind="euclidean", visual_threshold=5.0,
        visual_minimal_track_length=2, max_idle_epochs=5),
    "constraints": dict(
        positional_kind="iou", oriented=False, assignment="auction",
        visual_kind="euclidean", visual_threshold=5.0,
        visual_minimal_track_length=2, max_idle_epochs=5,
        constraints=((1, 1.0), (5, 3.0))),
}


# rotated rectangles as clip columns (xc, yc, r1x, r1y, r2x, r2y, radius,
# area) whose corner offsets are integers (half-extent vectors along
# Pythagorean directions, wound as geometry.box_vertices winds them), so
# the clip is exact: each against itself has IoU exactly 1.0
EXACT_BOX_COLUMNS = [
    (5.5, -3.25, -11.0, 2.0, -5.0, 10.0, 125.0 ** 0.5, 200.0),
    (812.0, 640.5, 7.0, -17.0, -17.0, -7.0, 338.0 ** 0.5, 676.0),
    (-40.0, 90.0, -23.0, 7.0, -7.0, 23.0, 578.0 ** 0.5, 960.0),
]


def one_cpu_thread() -> None:
    """Run PyTorch's CPU ops on one intra-op thread.  The suite runs
    several pytest workers on few cores, and an oversubscribed thread pool
    slows the parity tests' many small ops by an order of magnitude or
    more (the auction's price war on a contested matrix above all)."""
    import torch

    torch.set_num_threads(1)


def random_boxes(rng, n, spread=900.0):
    """Boxes at any angle, aspect 0.4-2.5, height 15-60 px."""
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, spread, n)
    b[:, 1] = rng.uniform(0, spread, n)
    b[:, 2] = rng.uniform(0, 2 * np.pi, n)
    b[:, 3] = rng.uniform(0.4, 2.5, n)
    b[:, 4] = rng.uniform(15, 60, n)
    return b


def oriented_stream(seed, steps, d, spread=300.0, oriented=True):
    """Random-walk boxes of 20-40 px with slowly turning angles (0 when not
    `oriented`), confidences U(0.4, 1), two padded rows per frame and half
    the rows of the middle frame padded."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (d, 2)).astype(np.float32)
    wh = rng.uniform(20, 40, (d, 2)).astype(np.float32)
    ang = rng.uniform(0, 0.6, d).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        ang += rng.uniform(-0.03, 0.03, d).astype(np.float32)
        box[s, :, 0] = xy[:, 0]
        box[s, :, 1] = xy[:, 1]
        box[s, :, 2] = ang if oriented else 0.0
        box[s, :, 3] = wh[:, 0] / wh[:, 1]
        box[s, :, 4] = wh[:, 1]
    conf = rng.uniform(0.4, 1.0, (steps, d)).astype(np.float32)
    valid = np.ones((steps, d), bool)
    for s in range(steps):
        valid[s, rng.integers(0, d, 2)] = False
    valid[steps // 2, d // 2:] = False
    return box, conf, valid


def sort_stream(seed, steps, d, density=300.0):
    """Random-walk boxes; half the rows of the middle frame are padding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, density, size=(d, 2)).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    valid = np.ones((steps, d), bool)
    for s in range(steps):
        xy += rng.uniform(-2, 2, size=xy.shape).astype(np.float32)
        box[s, :, 0] = xy[:, 0]
        box[s, :, 1] = xy[:, 1]
        box[s, :, 3] = 0.5
        box[s, :, 4] = 25.0
    valid[steps // 2, d // 2:] = False
    return box, valid


# the public trackers' predicted boxes, as tests/test_host_sort.py holds
# its two engines
API_RTOL, API_ATOL = 2e-4, 1e-3


def churn_stream(seed, steps, n, spread=2000.0, churn=0, angle=0.0):
    """tests/test_host_sort.py's stream as a list of (boxes [n, 5], conf
    [n]) frames: random-walk boxes of 30-60 px, and every `churn` frames a
    third of the objects replaced by fresh far-away ones.  `angle` > 0
    gives each object a fixed angle U(0, angle)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, (n, 2)).astype(np.float32)
    ang = (np.random.default_rng(seed + 1000).uniform(0, angle, n)
           .astype(np.float32))
    frames = []
    for s in range(steps):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        if churn and s and s % churn == 0:
            k = n // 3
            idx = rng.choice(n, k, replace=False)
            xy[idx] = rng.uniform(0, spread, (k, 2)).astype(np.float32)
        boxes = np.zeros((n, 5), np.float32)
        boxes[:, :2] = xy
        boxes[:, 2] = ang
        boxes[:, 3] = wh[:, 0] / wh[:, 1]
        boxes[:, 4] = wh[:, 1]
        conf = rng.uniform(0.5, 1.0, (n,)).astype(np.float32)
        frames.append((boxes.copy(), conf))
    return frames


def sort_overflow_stream(steps, d, seed=3):
    """Far-apart fresh objects every frame (a new track per detection),
    with a varying count: the trailing rows stay all-zero padding."""
    rng = np.random.default_rng(seed)
    box = np.zeros((steps, d, 5), np.float32)
    valid = np.zeros((steps, d), bool)
    for s in range(steps):
        n = int(rng.integers(3, d))
        box[s, :n, 0] = rng.uniform(0, 1e5, n)
        box[s, :n, 1] = rng.uniform(0, 1e5, n)
        box[s, :n, 3] = 0.5
        box[s, :n, 4] = 25.0
        valid[s, :n] = True
    return box, valid


def visual_stream(seed, steps, d, f, density=300.0):
    """Random-walk boxes with per-object identities plus noise; padding
    rows and missing features on some frames."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, density, size=(d, 2)).astype(np.float32)
    ident = rng.normal(size=(d, f)).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    feat = np.zeros((steps, d, f), np.float32)
    valid = np.ones((steps, d), bool)
    fvalid = np.ones((steps, d), bool)
    qual = rng.uniform(0.3, 1.0, size=(steps, d)).astype(np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, size=xy.shape).astype(np.float32)
        box[s, :, 0] = xy[:, 0]
        box[s, :, 1] = xy[:, 1]
        box[s, :, 3] = 0.5
        box[s, :, 4] = 25.0
        feat[s] = ident + 0.05 * rng.normal(size=(d, f)).astype(np.float32)
    valid[steps // 2, d // 2:] = False
    fvalid[1, : d // 4] = False
    fvalid[steps - 2, d // 2:] = False
    conf = np.ones((steps, d), np.float32)
    oa = np.ones((steps, d), np.float32)
    return box, conf, valid, feat, fvalid, qual, oa


def oriented_visual_stream(seed, steps, d, f, spread=300.0):
    """`oriented_stream`'s turning boxes (two padded rows per frame, half
    the middle frame padded) with per-object identities plus noise, some
    rows without features and qualities U(0.3, 1)."""
    box, conf, valid = oriented_stream(seed, steps, d, spread)
    rng = np.random.default_rng(seed + 100)
    ident = rng.normal(size=(d, f)).astype(np.float32)
    feat = (ident[None] + 0.05 * rng.normal(size=(steps, d, f))).astype(
        np.float32)
    fvalid = rng.uniform(size=(steps, d)) < 0.85
    qual = rng.uniform(0.3, 1.0, (steps, d)).astype(np.float32)
    return box, conf, valid, feat, fvalid, qual, np.ones((steps, d),
                                                         np.float32)


def visual_overflow_stream(steps, d, f, seed=7):
    """Far-apart fresh objects with random features every frame."""
    rng = np.random.default_rng(seed)
    box = np.zeros((steps, d, 5), np.float32)
    for s in range(steps):
        box[s, :, 0] = rng.uniform(0, 1e5, d)
        box[s, :, 1] = rng.uniform(0, 1e5, d)
        box[s, :, 3] = 0.5
        box[s, :, 4] = 25.0
    feat = rng.normal(size=(steps, d, f)).astype(np.float32)
    ones = np.ones((steps, d), np.float32)
    tru = np.ones((steps, d), bool)
    return box, ones, tru, feat, tru, ones, ones


def visual_padded_stream(steps, d, f, seed=11):
    """A varying detection count per frame; the other rows are all-zero
    boxes, features and confidences."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (d, 2)).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    feat = np.zeros((steps, d, f), np.float32)
    valid = np.zeros((steps, d), bool)
    conf = np.zeros((steps, d), np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        n = int(rng.integers(1, d))
        box[s, :n, 0] = xy[:n, 0]
        box[s, :n, 1] = xy[:n, 1]
        box[s, :n, 3] = 0.9
        box[s, :n, 4] = 30.0
        conf[s, :n] = rng.uniform(0.4, 1.0, n)
        valid[s, :n] = True
        feat[s, :n] = rng.normal(size=(n, f)).astype(np.float32)
    ones = np.ones((steps, d), np.float32)
    return box, conf, valid, feat, valid.copy(), ones, ones


def crowded_stream(seed, steps, d, n, f, spread, jitter=4.0, noise=1.1,
                   copies=2):
    """A crowded scene that makes the auction contend.  n random-walk
    objects of 30-60 px share a spread x spread area, so neighbours
    overlap, and each is detected with +-jitter px of noise.  Rows n..d-1
    re-detect random objects, as a detector without NMS does: the first
    `copies` of them repeat a detection exactly (box, confidence, feature
    and quality, so equal bids meet and the lowest row must win), the
    others are jittered.  Identities carry `noise` per dimension, so many
    appearance matches fail and those rows fall to the positional auction,
    where several bid for one track and outbid owners bid again."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, (n, 2)).astype(np.float32)
    ident = rng.normal(size=(n, f)).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    feat = np.zeros((steps, d, f), np.float32)
    conf = rng.uniform(0.4, 1.0, (steps, d)).astype(np.float32)
    qual = rng.uniform(0.3, 1.0, (steps, d)).astype(np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        src = np.concatenate([np.arange(n), rng.integers(0, n, d - n)])
        p = xy[src] + rng.uniform(-jitter, jitter, (d, 2)).astype(np.float32)
        box[s, :, 0] = p[:, 0]
        box[s, :, 1] = p[:, 1]
        box[s, :, 3] = wh[src, 0] / wh[src, 1]
        box[s, :, 4] = wh[src, 1]
        feat[s] = ident[src] + noise * rng.normal(size=(d, f)).astype(
            np.float32)
        rep = slice(n, n + copies)
        for a in (box, feat, conf, qual):
            a[s, rep] = a[s, src[rep]]
    tru = np.ones((steps, d), bool)
    return box, conf, tru, feat, tru.copy(), qual, np.ones((steps, d),
                                                           np.float32)


def large_norm_stream(steps, d, f, norm=4e5, seed=5):
    """Far-apart objects whose identities have norm ~4e5: the gram form
    qn + gn - 2 q.g of a same-identity distance cancels to ~1e5 of f32
    noise (a few hundred units after the square root)."""
    rng = np.random.default_rng(seed)
    ident = rng.normal(size=(d, f))
    ident = (ident / np.linalg.norm(ident, axis=1, keepdims=True)
             * norm).astype(np.float32)
    xy = rng.uniform(0, 1e4, (d, 2)).astype(np.float32)
    box = np.zeros((steps, d, 5), np.float32)
    feat = np.zeros((steps, d, f), np.float32)
    for s in range(steps):
        # objects jump by more than their size: only features can match
        xy += rng.uniform(-60, 60, xy.shape).astype(np.float32)
        box[s, :, 0] = xy[:, 0]
        box[s, :, 1] = xy[:, 1]
        box[s, :, 3] = 0.5
        box[s, :, 4] = 25.0
        feat[s] = ident + rng.normal(size=(d, f)).astype(np.float32)
    ones = np.ones((steps, d), np.float32)
    tru = np.ones((steps, d), bool)
    return box, ones, tru, feat, tru, ones, ones


# the inputs of ops/visual_votes.py: the gallery cases and their thresholds
VOTE_CASES = ("base", "broadcast", "empty", "no_pass", "nan", "overflow")
VOTE_THRESHOLDS = {"euclidean": 6.0, "cosine": 0.7}


def votes_inputs(seed, s, d, t, k, f, kind, case="base"):
    """Features and gates for `visual_best_fit`: (q [S, D, F], g
    [S, T, K, F] f32, use_gate [S, D], compat [S, D, T], track_gate [S, T],
    feat_valid [S, T, K], det_valid [S, D], threshold).  Rows re-detect
    random tracks (0.3 noise a dimension, so a matching lane passes the
    kind's threshold and a foreign one does not) or new identities, and
    every gate drops a random tenth or so.  Every case holds ties: rows 2
    and 3 are exact copies (the lower row must win) and tracks 0 and 1
    the same gallery (the lower track must win).  Cases: "broadcast" gives
    compat one row for every detection (the step's stride-0 view);
    "empty" drops every row of scene 0; "no_pass" a threshold no lane
    passes; "nan" NaN features on every fourth row from row 1 and on one
    gallery lane; "overflow" a threshold every lane passes, with row 0
    scaled past f32's range, so its euclidean distances are infinite and
    the weights NaN or infinite."""
    rng = np.random.default_rng(seed)
    ident = rng.normal(size=(s, t, f)).astype(np.float32)
    g = ident[:, :, None, :] + 0.3 * rng.normal(size=(s, t, k, f)).astype(
        np.float32)
    src = rng.integers(0, t, (s, d))
    q = np.take_along_axis(ident, src[..., None], axis=1)
    new = rng.random((s, d)) < 0.3
    q = np.where(new[..., None], rng.normal(size=(s, d, f)), q)
    q = (q + 0.3 * rng.normal(size=(s, d, f))).astype(np.float32)
    if d > 3:
        q[:, 3] = q[:, 2]
    if t > 1:
        g[:, 1] = g[:, 0]
    use_gate = rng.random((s, d)) < 0.9
    compat = rng.random((s, d, t)) < 0.85
    track_gate = rng.random((s, t)) < 0.9
    feat_valid = rng.random((s, t, k)) < 0.8
    det_valid = rng.random((s, d)) < 0.95
    threshold = VOTE_THRESHOLDS[kind]
    if case == "broadcast":
        compat = np.broadcast_to(compat[:, :1], compat.shape)
    elif case == "empty":
        use_gate[0] = det_valid[0] = False
    elif case == "no_pass":
        threshold = 1e-3 if kind == "euclidean" else 1.5
    elif case == "nan":
        q[:, 1::4] = np.nan
        g[:, t // 2, k - 1] = np.nan
    elif case == "overflow":
        threshold = float("inf") if kind == "euclidean" else -float("inf")
        q[:, 0] *= np.float32(1e20)
    return (q, g, use_gate, compat, track_gate, feat_valid, det_valid,
            threshold)


def votes_args(inputs, kind, precision, device):
    """`votes_inputs` as `visual_best_fit`'s arguments on `device`: (dot,
    qn, gn, use_gate, compat, track_gate, feat_valid, det_valid, kind,
    threshold), the product and norms taken as the step takes them (bf16
    rounds both sides first).  A broadcast compat stays a stride-0 view."""
    import torch
    from similari_tpu_torch.ops import distances

    q, g, use_gate, compat, track_gate, feat_valid, det_valid, thr = inputs
    tq, tg = (torch.tensor(x, device=device) for x in (q, g))
    if precision == "bf16":
        tq, tg = tq.to(torch.bfloat16), tg.to(torch.bfloat16)
    dot, qn, gn = distances.gram(tq, tg, kind)
    if compat.strides[1] == 0:
        tc = torch.tensor(np.ascontiguousarray(compat[:, :1]),
                          device=device).expand(compat.shape)
    else:
        tc = torch.tensor(compat, device=device)
    gates = [torch.tensor(x, device=device)
             for x in (use_gate, track_gate, feat_valid, det_valid)]
    return (dot, qn, gn, gates[0], tc, *gates[1:], kind, thr)


# the auction kernel's cases (ops/assignment.py::auction_fb_cuda): name ->
# (scenes, rows D, columns T)
AUCTION_CASES = {
    "tracking": (3, 16, 24),
    "row_ties": (2, 12, 16),
    "col_ties": (2, 12, 16),
    "zero_scene": (3, 10, 12),
    "below_theta": (2, 8, 12),
    "d_over_t": (3, 24, 5),
    "t1": (4, 12, 1),
    "contested": (4, 12, 12),
    "negative_theta": (2, 6, 12),
    "nan_masked": (3, 16, 24),
    "nan_raw": (2, 8, 12),
    "inf_raw": (2, 8, 12),
}
# cases whose weights are given raw (no mask); with NaN or inf in them eps
# is not finite and rows may stay pending to the cap, so their tests cap
# the rounds at RAW_ROUNDS
RAW_CASES = ("nan_raw", "inf_raw")
RAW_ROUNDS = 12


def tracking_weights(seed, s, d, t, spread=None):
    """SORT-step-shaped voting weights for `solve_voting`: (metric f32
    [S, D, T], row_valid [S, D], col_valid [S, T]).  Each scene has T
    tracks of 20-40 px at random in a square where a box overlaps a few
    others; 70-90% of the rows re-detect distinct tracks with a 3 px
    jitter, the rest are new boxes; the metric is IoU x confidence
    (U(0.4, 1)) where that reaches 0.3, else 0, as `distance_weights`
    makes it; a tenth of the rows are padding and the last tracks are
    free slots."""
    rng = np.random.default_rng(seed)
    spread = spread or 30.0 * np.sqrt(t)
    cx = rng.uniform(0, spread, (s, t)).astype(np.float32)
    cy = rng.uniform(0, spread, (s, t)).astype(np.float32)
    tw = rng.uniform(20, 40, (s, t)).astype(np.float32)
    th = rng.uniform(20, 40, (s, t)).astype(np.float32)
    src = np.argsort(rng.random((s, t)), axis=1)[:, :d] if d <= t else \
        rng.integers(0, t, (s, d))
    pick = lambda a: np.take_along_axis(a, src, axis=1)  # noqa: E731
    jit = lambda n: rng.uniform(-3, 3, (s, n)).astype(np.float32)  # noqa
    dx, dy = pick(cx) + jit(d), pick(cy) + jit(d)
    dw, dh = pick(tw) + jit(d), pick(th) + jit(d)
    new = rng.random((s, d)) > rng.uniform(0.7, 0.9, (s, 1))
    dx = np.where(new, rng.uniform(0, spread, (s, d)), dx).astype(np.float32)
    dy = np.where(new, rng.uniform(0, spread, (s, d)), dy).astype(np.float32)
    def overlap(dc, dl, tc, tl):  # [S, D, T] along one axis
        lo = np.maximum(dc[..., None] - dl[..., None] / 2,
                        tc[:, None] - tl[:, None] / 2)
        hi = np.minimum(dc[..., None] + dl[..., None] / 2,
                        tc[:, None] + tl[:, None] / 2)
        return hi - lo

    ix, iy = overlap(dx, dw, cx, tw), overlap(dy, dh, cy, th)
    inter = np.where((ix > 0) & (iy > 0), ix * iy, 0).astype(np.float32)
    union = (dw * dh)[..., None] + (tw * th)[:, None] - inter
    conf = rng.uniform(0.4, 1.0, (s, d, 1)).astype(np.float32)
    m = (inter / union * conf).astype(np.float32)
    m = np.where(m >= 0.3, m, 0).astype(np.float32)
    row_valid = rng.random((s, d)) < 0.9
    col_valid = np.arange(t)[None] < t - rng.integers(0, max(t // 8, 1) + 1,
                                                      (s, 1))
    return m, row_valid, col_valid


def auction_inputs(seed, case):
    """(weights f32 [S, D, T], row_valid, col_valid, theta) of an
    `AUCTION_CASES` case; the masks are None for the raw cases, whose
    weights go to `auction_lap_fallback` unmasked."""
    s, d, t = AUCTION_CASES[case]
    rng = np.random.default_rng(seed)
    w, rv, cv = tracking_weights(seed, s, d, t)
    theta = 0.3
    if case == "row_ties":  # exact copies of row 0, and equal values
        w = (rng.integers(0, 3, (s, d, t)) / 2).astype(np.float32)
        w[:, 1::2] = w[:, :1]
    elif case == "col_ties":  # many equal maxima within a row
        w = (0.5 + 0.5 * (rng.integers(0, 3, (s, d, t)) // 2)).astype(
            np.float32)
    elif case == "zero_scene":
        w[0] = 0.0
    elif case == "below_theta":
        w = rng.uniform(0, 0.29, (s, d, t)).astype(np.float32)
    elif case in ("d_over_t", "t1"):
        w = rng.uniform(0, 1, (s, d, t)).astype(np.float32)
    elif case == "contested":  # scene 0: every row wants every column
        w[0] = (0.5 + 0.01 * rng.random((d, t))).astype(np.float32)
        rv[0] = cv[0] = True
    elif case == "negative_theta":  # zero weights beat the fallback
        theta = -0.2
    elif case == "nan_masked":
        w[rng.random(w.shape) < 0.1] = np.nan
    elif case == "nan_raw":
        w = rng.uniform(0, 1, (s, d, t)).astype(np.float32)
        w[0, 1, 2] = np.nan
    elif case == "inf_raw":
        w = rng.uniform(0, 1, (s, d, t)).astype(np.float32)
        w[0, 2, 5] = np.inf
        w[1, 3, 1] = -np.inf
    if case in RAW_CASES:
        return w, None, None, theta
    return w, rv, cv, theta


def jax_state_dict(state) -> dict:
    """A JAX state dataclass as the dict `similari_tpu_torch.convert` reads:
    `np.asarray` per field, `kf` nested."""
    out = {}
    for fld in dataclasses.fields(state):
        v = getattr(state, fld.name)
        if fld.name == "kf":
            out["kf"] = {k.name: np.asarray(getattr(v, k.name))
                         for k in dataclasses.fields(v)}
        else:
            a = np.asarray(v)
            # bfloat16 (a numpy extension type) crosses as float32
            out[fld.name] = a if a.dtype.kind in "biuf" else a.astype(
                np.float32)
    return out


def assert_state_dicts_match(a: dict, b: dict) -> None:
    """Integer and boolean fields exactly; boxes and Kalman state at
    RTOL/ATOL; gallery and feature history at GALLERY_TOL."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "kf":
            for name in a["kf"]:
                np.testing.assert_allclose(b["kf"][name], a["kf"][name],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"kf.{name}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if x.dtype.kind in "biu":
            np.testing.assert_array_equal(y, x, err_msg=k)
        elif k in ("feats", "hist_feat"):
            np.testing.assert_allclose(y.astype(np.float32),
                                       x.astype(np.float32),
                                       rtol=GALLERY_TOL, atol=GALLERY_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL, err_msg=k)


# The host engines solve the voting LP exactly; the device step solves it
# with the auction on CUDA and with scipy on the CPU.  Where two solutions
# of one frame differ, they are accepted only if their LP totals tie within
# this relative tolerance.
LP_TIE_RTOL = 1e-5


def voting_lp_total(weights, theta, cols, rows, slot, is_new):
    """The voting LP's total of one solution: weights [D, C] against the
    state's compatible slots `cols` [C]; over the rows in `rows` (a bool
    mask), a matched row scores its slot's weight and a new row `theta`
    (its private diagonal)."""
    col_of = {int(c): i for i, c in enumerate(np.asarray(cols))}
    total = 0.0
    for r in np.flatnonzero(rows):
        if is_new[r]:
            total += float(theta)
        else:
            total += float(weights[r, col_of[int(slot[r])]])
    return total


def solutions_tie(cfg, state, box, conf, epoch, rows, a, b) -> bool:
    """Whether two solutions (slot, is_new) of one frame's voting LP tie
    within LP_TIE_RTOL over the rows in `rows`.  `state` is the numpy-leaf
    state before the step; `cfg` a SORT config, or a visual config, whose
    positional LP is the SORT one with its positional fields."""
    from similari_tpu_torch.trackers.host_sort import _host_weights
    from similari_tpu_torch.trackers.sort_step import SortConfig

    if not isinstance(cfg, SortConfig):
        cfg = SortConfig(method=cfg.positional_kind,
                         iou_threshold=cfg.iou_threshold,
                         min_confidence=cfg.positional_min_confidence,
                         max_idle_epochs=cfg.max_idle_epochs,
                         constraints=cfg.constraints, oriented=cfg.oriented)
    cols = np.flatnonzero(state.active & (
        epoch - state.last_epoch <= cfg.max_idle_epochs))
    w = _host_weights(cfg, state, np.asarray(box, np.float32),
                      np.asarray(conf, np.float32), epoch, cols)
    th = cfg.new_track_threshold
    ta = voting_lp_total(w, th, cols, rows, *a)
    tb = voting_lp_total(w, th, cols, rows, *b)
    return abs(ta - tb) <= LP_TIE_RTOL * max(abs(ta), abs(tb), 1.0)


MOT_HEADER = "frame,id,bb_left,bb_top,bb_width,bb_height,conf,x,y,z"


def write_mot_det(path, detections, columns: int = 7,
                  header: bool = False) -> dict:
    """Write {frame: [(left, top, width, height, conf), ...]} as a MOT det
    csv with 7 columns (`frame, -1, l, t, w, h, conf`) or 6 (no
    confidence), behind a header line if asked.  Every value is written
    as the shortest decimal of its float32, so a reader that parses to
    float32 reads back exactly these values.  Returns the detections as
    the file holds them: float32 values, confidence 1.0 for 6 columns."""
    assert columns in (6, 7)
    lines = [MOT_HEADER] if header else []
    held = {}
    for frame in sorted(detections):
        rows = []
        for det in detections[frame]:
            v = [float(np.float32(x)) for x in det]
            if columns == 6:
                v[4] = 1.0
            rows.append(tuple(v))
            cells = [str(frame), "-1"] + [str(np.float32(x))
                                          for x in v[:columns - 2]]
            lines.append(",".join(cells))
        held[frame] = rows
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return held
