"""The CUDA kernels' splits of their work, replayed on the CPU (tests only).

No kernel runs on the CPU, and the plain PyTorch versions compute each
function whole.  These replays compute it as a kernel splits it, over the
blocks of a thread-block cluster, the lanes of a pair or the tiles of a
product, in the kernel's order, so the tests can hold the split to the
plain version bit for bit:

- the fused SORT kernel (`csrc/fused_track.cu::fused_sort_kernel`): the
  auction over G column blocks (`cluster_auction_replay`) and the free
  slots from the blocks' counts (`cluster_slots_replay`);
- the fused VisualSORT kernel (`fused_visual_kernel`), its slots dealt to
  the blocks in turn: the max gallery distance and the span from the
  blocks' partials (`visual_max_distance_replay`, the auction's span),
  each row's first max merged from the blocks' partials and the wins test
  against the owner block's heaviest row (`visual_best_fit_replay`), the
  auction over dealt columns, and the free slots in slot order from the
  blocks' bit masks (`visual_slots_replay`);
- the fallback auction kernel (`csrc/auction.cu::auction_fb_kernel`):
  each scene to its own convergence over a pending-row list, L lanes a
  row, keys cleared by the winners (`auction_fb_replay`);
- the clip kernel (`csrc/clip.cu`): 8 lanes per in-radius pair
  (`clip_lanes_replay`);
- the bf16 gallery product (`csrc/gallery_dots.cu`): the staged copy and
  its output tiles (`stage_bf16`, `staged_dots_replay`).
"""

from __future__ import annotations

import numpy as np
import torch

from similari_tpu_torch.ops.assignment import (MAX_AUCTION_ROUNDS, NEG,
                                               UNROLLED_ROUNDS, first_argmax)
from similari_tpu_torch.ops.clip import _edge_term, _iou, _recentred, far_pairs
from similari_tpu_torch.ops.fused_visual import VISUAL_THREADS
from similari_tpu_torch.ops.gallery_dots import (PAD, TILE_COLS, TILE_ROWS,
                                                 f32_dots)

_F32 = torch.float32


# ---------------------------------------------------------------------------
# the fused kernels' auction and slots over a thread-block cluster
# ---------------------------------------------------------------------------

def cluster_columns(d: int, t: int, g: int, dealt: bool = False):
    """Owner block of each column of the augmented [D, D+T] matrix when G
    blocks split it as the fused kernels do: block b owns the diagonal
    columns [b*ceil(D/G), ...) and the track columns D + [b*ceil(T/G), ...)
    (SORT), or D + t for every t with t % G == b (VisualSORT, `dealt`);
    the last slices are ragged and may be empty."""
    dc, tc = -(-d // g), -(-t // g)
    tracks = torch.arange(t) % g if dealt else torch.arange(t) // tc
    return torch.cat([torch.arange(d) // dc, tracks])


def _top2(values: torch.Tensor, n: int):
    """Per row: (first max, its column, the largest other value) over the
    columns of `values`; (-inf, n, -inf) when there are none."""
    rows = values.shape[0]
    inf = torch.full((rows,), -torch.inf)
    if values.shape[1] == 0:
        return inf, torch.full((rows,), n), inf
    b1, i1 = first_argmax(values, 1)
    rest = values.index_put((torch.arange(rows), i1), inf)
    b2 = rest.max(dim=1).values if values.shape[1] > 1 else inf
    return b1, i1, b2


def bid_keys(bid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (bid, then the lower row): the float's bits
    made order-preserving, then the inverted row, as the kernel packs them
    (below its round tag) into one 64-bit word for its shared-memory
    atomicMax; shifted by 2^63 to stay signed here."""
    u = bid.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)
    return (order - 0x80000000) * (1 << 32) + (0xFFFFFFFF - rows)


def cluster_auction_replay(A: torch.Tensor, dvalid: torch.Tensor, g: int,
                           dealt: bool = False):
    """`forward_auction_plain` as G column blocks run it
    (`fused_track.cuh::cluster_auction`): the span is the largest of the
    blocks' maxima over their own columns; each block takes the bidding
    rows' (first max, column, runner-up) over its own columns, the
    partials merge in ascending block order by `warp_top2`'s rule, each
    column keeps the bid with the highest (bid, lowest row) key, and the
    winners take their columns, evicting the owners.  Returns (r2c[D],
    rounds, bids)."""
    d, n = A.shape
    owner = cluster_columns(d, n - d, g, dealt)
    blocks = [torch.nonzero(owner == b).flatten() for b in range(g)]
    span = torch.tensor(-torch.inf)
    for cols in blocks:
        if len(cols):
            span = torch.maximum(span, A[:, cols].max())
    span = torch.clamp(span, min=1e-6)
    eps = span / max(4096.0, 64.0 * d)
    rows = torch.arange(d)
    prices = torch.zeros(n, dtype=_F32)
    c2r = torch.full((n,), -1, dtype=torch.int64)
    r2c = torch.where(dvalid, -1, 0).to(torch.int64)
    rounds = bids = 0
    none = torch.iinfo(torch.int64).min
    while rounds < MAX_AUCTION_ROUNDS:
        pending = dvalid & (r2c < 0)
        if not bool(pending.any()):
            break
        rounds += 1
        bids += int(pending.sum())
        b1 = i1 = b2 = None
        for cols in blocks:  # ascending block order
            pb1, pi1, pb2 = _top2(A[:, cols] - prices[cols], n)
            if len(cols):
                pi1 = cols[pi1]
            if b1 is None:
                b1, i1, b2 = pb1, pi1, pb2
                continue
            take = (pb1 > b1) | ((pb1 == b1) & (pi1 < i1))
            b2 = torch.where(take, torch.maximum(b1, pb2),
                             torch.maximum(pb1, b2))
            b1, i1 = torch.where(take, pb1, b1), torch.where(take, pi1, i1)
        bid = prices[i1] + (b1 - b2) + eps
        bidding = pending & (bid > NEG * 0.5)
        keys = bid_keys(bid, rows)
        best = torch.full((n,), none).scatter_reduce(
            0, i1[bidding], keys[bidding], "amax")
        won = bidding & (best[i1] == keys)
        cols = i1[won]
        old = c2r[cols]
        r2c[old[old >= 0]] = -1
        c2r[cols] = rows[won]
        prices[cols] = bid[won]
        r2c[won] = cols
    return r2c, rounds, bids


def _lane_columns(t: int, lanes: int, vec: bool):
    """The columns each of L lanes scans, in its order: 4 at a time from
    column 4 * lane in steps of 4 L (vec), else from `lane` in steps of L."""
    if vec:
        return [[4 * q + k for q in range(sub, t // 4, lanes)
                 for k in range(4)] for sub in range(lanes)]
    return [list(range(sub, t, lanes)) for sub in range(lanes)]


def _fb_top(values, lane_cols):
    """(v1, its column, v2 before the NaN rule, NaN count) of one row: each
    lane's running (b1, i1, b2, NaN count) in its column order, merged
    over the lanes by the kernel's butterfly (xor L/2 .. 1)."""
    f = np.float32
    tops = []
    for cols in lane_cols:
        b1, b2, i1, nan = f(-np.inf), f(-np.inf), (cols[0] if cols
                                                   else 2 ** 31 - 1), 0
        for j in cols:
            v = values[j]
            isn = bool(np.isnan(v))
            nan += isn
            vn = f(-np.inf) if isn else v
            if vn > b1:
                b1, b2, i1 = vn, b1, j
            elif vn > b2:
                b2 = vn
        tops.append((b1, i1, b2, nan))
    o = len(tops) // 2
    while o:
        nxt = []
        for lane, (b1, i1, b2, nan) in enumerate(tops):
            ob1, oi1, ob2, on = tops[lane ^ o]
            better = ob1 > b1 or (ob1 == b1 and oi1 < i1)
            nb2 = max(b1, ob2) if better else max(ob1, b2)
            nxt.append((ob1, oi1, nb2, nan + on) if better
                       else (b1, i1, nb2, nan + on))
        tops, o = nxt, o // 2
    return tops[0]


def auction_fb_replay(weights, theta: float, max_iters=MAX_AUCTION_ROUNDS,
                      row_valid=None, col_valid=None, lanes: int = 8,
                      vec: bool = False):
    """`auction_fb_kernel` on weights [S, D, T] (numpy f32; with the bool
    masks, `edges` applied as it loads), each scene alone: round 1 over
    every row with the scene's min and max, eps by the rounded reciprocal,
    then only the pending rows, each row's top-2 from L lanes, bids as
    (bid, inverted row) keys per column, the winner clearing its column's
    key.  Returns (columns int64 [S, D], rounds a scene, the call's
    `auction.rounds`)."""
    f = np.float32
    w = np.asarray(weights, np.float32)
    s, d, t = w.shape
    if row_valid is not None:
        ok = (np.asarray(row_valid)[:, :, None]
              & np.asarray(col_valid)[:, None, :] & ~np.isnan(w))
        w = np.where(ok, w, f(0.0)).astype(np.float32)
    th = f(theta)
    cap = max(UNROLLED_ROUNDS, max_iters)
    inv = f(1.0) / f(max(4096.0, 64.0 * d))
    lane_cols = _lane_columns(t, lanes, vec)
    out = np.zeros((s, d), np.int64)
    rounds_out = []
    for sc in range(s):
        W = w[sc]
        wmax = f(np.nan) if np.isnan(W).any() else max(f(W.max()), th)
        wmin = f(np.nan) if np.isnan(W).any() else min(f(W.min()), f(0.0))
        span = f(wmax - wmin)
        span = span if np.isnan(span) else max(span, f(1e-6))
        eps = f(span * inv)
        prices = np.zeros(t, np.float32)
        c2r = np.full(t, -1)
        r2c = np.full(d, -1)
        pend, rounds = list(range(d)), 0
        while pend and rounds < cap:
            key, bids = {}, {}
            for r in pend:
                v1, j, b2, nan = _fb_top(W[r] - prices, lane_cols)
                if nan and v1 == -np.inf and np.isnan(W[r, j] - prices[j]):
                    nan -= 1
                v2 = f(np.nan) if nan else max(b2, f(NEG))
                if th >= v1:
                    r2c[r] = -2
                    continue
                c = v2 if np.isnan(v2) else max(v2, th)
                bid = f(f(prices[j] + f(v1 - c)) + eps)
                bids[r] = (j, bid)
                if bid > f(NEG * 0.5):
                    k = (float(bid) + 0.0, -r)  # -0 as +0, lower row first
                    key[j] = max(key.get(j, k), k)
            nxt = []
            for r, (j, bid) in bids.items():
                if bid > f(NEG * 0.5) and key.get(j) == (float(bid) + 0.0,
                                                         -r):
                    if c2r[j] >= 0:
                        r2c[c2r[j]] = -1
                        nxt.append(c2r[j])
                    c2r[j], prices[j], r2c[r] = r, bid, j
                else:
                    nxt.append(r)
            pend, rounds = nxt, rounds + 1
        out[sc] = np.where(r2c >= 0, d + r2c, np.arange(d))
        rounds_out.append(rounds)
    return out, rounds_out, max([UNROLLED_ROUNDS] + rounds_out)


def cluster_slots_replay(is_new: torch.Tensor, matched: torch.Tensor,
                         tgt: torch.Tensor, free: torch.Tensor, g: int):
    """`allocate_slots` as the SORT kernel's G blocks run it: block b lists
    its own free slots [b*ceil(T/G), ...) in order; an exclusive scan of
    the blocks' free counts places the r-th new detection at the owner of
    the r-th free slot, which looks it up in its own list."""
    t = free.shape[0]
    tc = -(-t // g)
    new_rank = torch.cumsum(is_new.to(torch.int64), 0)
    lists = [torch.nonzero(free[b * tc:(b + 1) * tc]).flatten() + b * tc
             for b in range(g)]
    counts = torch.tensor([len(x) for x in lists])
    pre = torch.cumsum(counts, 0) - counts
    n_free = int(counts.sum())
    slot = torch.full_like(new_rank, t - 1)
    for r, k in enumerate(new_rank.tolist()):
        if 1 <= k <= n_free:
            b = int(torch.nonzero((pre < k) & (k <= pre + counts))[0])
            slot[r] = lists[b][k - int(pre[b]) - 1]
    slot = torch.where(matched, tgt, slot)
    n_new = new_rank[-1]
    return slot, new_rank, n_new, n_new > n_free


# ---------------------------------------------------------------------------
# the fused VisualSORT kernel: slot t in block t % G, at index t // G there
# ---------------------------------------------------------------------------

def _dealt(t: int, g: int, b: int) -> torch.Tensor:
    """Block b's slots, in its own order (index q: slot b + q*G)."""
    return torch.arange(b, max(b, t), g)


def visual_max_distance_replay(dists, valids, g: int) -> torch.Tensor:
    """`_max_distance` as the kernel takes it: each block the largest
    passing distance over its own lanes' pairs (NEG when none), then the
    largest of the blocks' partials, read in block order."""
    t = valids[0].shape[1]
    out = torch.tensor(NEG, dtype=_F32)
    for b in range(g):
        cols = _dealt(t, g, b)
        part = torch.tensor(NEG, dtype=_F32)
        for (w, _), v in zip(dists, valids):
            if len(cols):
                part = torch.maximum(part, torch.where(
                    v[:, cols], w[:, cols], NEG).max())
        out = torch.maximum(out, part)
    return out


def _first_max_merge(parts):
    """Merge (value, index) partials in order: the larger value, the lower
    index among equal values (the kernel's merge of per-block and
    per-group partials)."""
    v, ix = parts[0]
    for pv, pi in parts[1:]:
        take = (pv > v) | ((pv == v) & (pi < ix))
        v, ix = torch.where(take, pv, v), torch.where(take, pi, ix)
    return v, ix


def visual_best_fit_replay(w_m: torch.Tensor, eligible: torch.Tensor,
                           g: int):
    """`ops/visual_votes.py::claim` as the kernel's blocks compute it:
    each block's (first max, column) of every row over its own columns,
    merged across the blocks; each own column's heaviest row from rs
    groups of rows (every rs-th row, rs = VISUAL_THREADS // own columns),
    merged; a row with any weight above NEG wins its best track when the
    owner block's heaviest row of that track is the row.  Returns (t1,
    has_any, wins, claimed)."""
    d, t = w_m.shape
    rows = torch.arange(d)
    row_parts, bestq = [], torch.zeros(t, dtype=torch.int64)
    for b in range(g):
        cols = _dealt(t, g, b)
        if len(cols) == 0:
            row_parts.append((torch.full((d,), -torch.inf),
                              torch.full((d,), t)))
            continue
        v, q = first_argmax(w_m[:, cols], 1)
        row_parts.append((v, cols[q]))
        rs = max(VISUAL_THREADS // len(cols), 1)
        groups = []  # the groups from row d on hold no row: (-inf, d)
        for r0 in range(min(rs, d)):
            sub = torch.arange(r0, d, rs)
            gv, gi = first_argmax(w_m[sub][:, cols], 0)
            groups.append((gv, sub[gi]))
        bestq[cols] = _first_max_merge(groups)[1]
    v, t1 = _first_max_merge(row_parts)
    has_any = v > NEG
    wins = has_any & (bestq[t1] == rows)
    claimed = torch.zeros(t, dtype=torch.bool)
    claimed[t1[wins]] = True
    return t1, has_any, wins, claimed


def visual_slots_replay(is_new: torch.Tensor, matched: torch.Tensor,
                        tgt: torch.Tensor, free: torch.Tensor, g: int):
    """`allocate_slots` as the VisualSORT kernel's blocks run it: each
    block publishes its own free slots as a bit mask (bit q for slot
    b + q*G); every block reads the G masks back into 32-slot words in slot
    order, counts them (an inclusive scan of the words' popcounts) and
    ranks each free slot by the count before its word plus the free bits
    below it; the r-th new row takes the free slot of rank r (only ranks
    up to D are kept), else T-1.  Returns (slot, new_rank inclusive, n_new,
    overflow)."""
    t, d = free.shape[0], is_new.shape[0]
    new_rank = torch.cumsum(is_new.to(torch.int64), 0)
    masks = [[bool(x) for x in free[_dealt(t, g, b)]] for b in range(g)]
    words = []
    for w0 in range(0, t, 32):
        m = 0
        for s in range(w0, min(w0 + 32, t)):
            if masks[s % g][s // g]:
                m |= 1 << (s - w0)
        words.append(m)
    counts = torch.cumsum(torch.tensor([bin(m).count("1") for m in words]),
                          0).tolist()
    n_free = counts[-1]
    flist = [t - 1] * d
    for s in range(t):
        wd, bit = divmod(s, 32)
        if (words[wd] >> bit) & 1:
            k = ((counts[wd - 1] if wd else 0)
                 + bin(words[wd] & ((2 << bit) - 1)).count("1"))
            if k <= d:
                flist[k - 1] = s
    slot = torch.tensor([flist[k - 1] if 1 <= k <= n_free else t - 1
                         for k in new_rank.tolist()])
    slot = torch.where(matched, tgt, slot)
    n_new = new_rank[-1]
    return slot, new_rank, n_new, n_new > n_free


# ---------------------------------------------------------------------------
# the clip kernel's lanes and the bf16 gallery product's tiles
# ---------------------------------------------------------------------------

def clip_lanes_replay(det8: torch.Tensor, trk8: torch.Tensor,
                      want_iou: bool) -> torch.Tensor:
    """The kernel's split of the clip: the in-radius pairs listed, each
    pair's 8 edge terms (2 passes x 4 edges) computed apart, as the 8
    lanes of its group do, then added in the fixed order
    (((c0 + c1) + c2) + c3) + (((c4 + c5) + c6) + c7); every other pair
    0."""
    rows, cols = (~far_pairs(det8, trk8)).nonzero(as_tuple=True)
    a, b = det8[rows], trk8[cols]
    ax, ay, bx, by = _recentred(a, b)
    e = ([_edge_term(ax, ay, bx, by, i, False) for i in range(4)]
         + [_edge_term(bx, by, ax, ay, i, True) for i in range(4)])
    s = (((e[0] + e[1]) + e[2]) + e[3]) + (((e[4] + e[5]) + e[6]) + e[7])
    inter = torch.abs(s) * 0.5
    out = torch.zeros((det8.shape[0], trk8.shape[0]), dtype=_F32,
                      device=det8.device)
    out[rows, cols] = _iou(inter, a[:, 7], b[:, 7]) if want_iou else inter
    return out


def stage_bf16(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bf16 staging pass's copy of [G ; X]: each row rounded to bf16
    (nearest even) once, zero-padded to a multiple of PAD columns."""
    cols = torch.cat([g, x])
    f = cols.shape[1]
    out = torch.zeros((cols.shape[0], -(-f // PAD) * PAD),
                      dtype=torch.bfloat16, device=cols.device)
    out[:, :f] = cols.to(torch.bfloat16)
    return out


def tile_needed(n: int, m: int, rows_per_frame: int, tm: int, r0: int,
                c0: int) -> bool:
    """Whether the output tile at (r0, c0) holds an entry of
    `needed_columns` (the kernels' `tile_needed`): a gallery column, or a
    chunk row of a later frame than its first chunk-row column."""
    if c0 < m:
        return True
    return (min(r0 + tm, n) - 1) // rows_per_frame > (c0 - m) // rows_per_frame


def staged_dots_replay(x: torch.Tensor, g: torch.Tensor,
                       rows_per_frame: int) -> torch.Tensor:
    """The bf16 product as the kernel tiles it: the staged copy multiplied
    in f32 over its padded width, one TILE_ROWS x TILE_COLS output tile at
    a time, the tiles the kernel skips left NaN."""
    st = stage_bf16(x, g).to(_F32)
    n, m = x.shape[0], g.shape[0]
    a = st[m:]
    out = torch.full((n, m + n), float("nan"), dtype=_F32, device=x.device)
    for r0 in range(0, n, TILE_ROWS):
        for c0 in range(0, m + n, TILE_COLS):
            if tile_needed(n, m, rows_per_frame, TILE_ROWS, r0, c0):
                out[r0:r0 + TILE_ROWS, c0:c0 + TILE_COLS] = f32_dots(
                    a[r0:r0 + TILE_ROWS], st[c0:c0 + TILE_COLS])
    return out
