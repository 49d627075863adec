"""Linear assignment (maximisation) for tracker voting (mirrors
`similari_tpu/ops/assignment.py`).

Rows are detections, columns the detections' private "new track" columns
followed by the tracks: the augmented [D, D+T] matrix of the reference's
voting, with the new-track threshold on the diagonal.  Every solver
returns, per row, a column in that convention: col < D is a new track,
col >= D is track col - D.

* `auction_lap_fallback` / `auction_lap`: the Jacobi forward auction of the
  JAX package, round for round (3 rounds, then more until every row is
  assigned or 3000 rounds ran).  Ties go to the first column and the lowest
  row.  A leading scene axis [S, D, N] solves S problems at once, each with
  its own eps, as the JAX package's vmap does.
  - On the card `auction_lap_fallback` (and `solve_voting`'s auction) is
    one launch of the CUDA kernel `csrc/auction.cu::auction_fb_kernel`
    (counter `auction.launches`): each scene bids to convergence on the
    device, with no host check, and the rounds are a device counter
    (`utils/profiling.py::device_counter`).
  - On the CPU it runs the plain rounds, `auction_lap_fallback_plain`:
    tensor code on the device of its input, with one host check per round
    after the third (the wait `auction.converged`).  The two give the same
    columns bit for bit, and the same `auction.rounds` a call: max(3, the
    rounds until no row of any scene is pending).
  - `auction_lap` (the augmented matrix) is tensor code everywhere.
* `hungarian_host`: the exact optimum by scipy's `linear_sum_assignment`;
  the matrix goes to the host and the columns come back.
* `native_host`: the exact optimum by the port's host C++ solver
  (`csrc/lap.cpp`, `ops/lap.py`), the JAX package's `native` backend: the
  matrix goes to the host, a scene batch is solved in one call over a
  thread pool, and the columns come back.

The JAX package's general step solves the auction in XLA, not in a Pallas
kernel; the fallback auction's CUDA kernel replaces the eager rounds'
passes and host checks on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import count, device_counter, wait

NEG = -1e30
MAX_AUCTION_ROUNDS = 3000
# rounds run before the first convergence check; tracking-shaped matrices
# converge in 1-3 rounds, and a round changes nothing once all rows hold
UNROLLED_ROUNDS = 3

def first_argmax(values: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, lowest index of the max) along `dim`.  NaN ranks below every
    number, as in the CUDA kernels' `v > best` scans, so the index is always
    in range: a slice of NaN only gives (-inf, 0)."""
    if values.is_floating_point():
        values = torch.nan_to_num(values, nan=-torch.inf, posinf=torch.inf,
                                  neginf=-torch.inf)
    m = values.max(dim=dim, keepdim=True).values
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    idx = torch.arange(n, device=values.device).reshape(shape)
    first = torch.where(values >= m, idx, n).min(dim=dim).values
    return m.squeeze(dim), first


def _second_best(values: torch.Tensor, j_best: torch.Tensor) -> torch.Tensor:
    """Row max of values[S, D, N] with each row's best column taken out."""
    return values.scatter(-1, j_best[..., None], NEG).max(dim=-1).values


def _column_side(bidders, j_best, bid, prices, row_to_col, col_to_row):
    """Each column takes its highest bid (the lowest row among equal bids);
    owners of re-auctioned columns are evicted.  Rows [S, D], columns
    [S, N].  Returns (prices, row_to_col with -1 for evicted rows and the
    won column for winners, col_to_row)."""
    s, d = row_to_col.shape
    n = prices.shape[-1]
    cols = torch.arange(n, device=prices.device)
    bids = torch.where(bidders[..., None] & (j_best[..., None] == cols),
                       bid[..., None], NEG)
    best_bid, winner_row = first_argmax(bids, -2)
    got = best_bid > NEG * 0.5
    evicted = torch.zeros((s, d + 1), dtype=torch.bool, device=prices.device)
    evicted.scatter_(-1, torch.where(got & (col_to_row >= 0), col_to_row, d),
                     True)
    # a row bids on one column, so it wins at most one
    won_col = torch.full((s, d + 1), -1, dtype=torch.int64,
                         device=prices.device)
    won_col.scatter_(-1, torch.where(got, winner_row, d), cols.expand(s, n))
    won_col, evicted = won_col[:, :d], evicted[:, :d]
    row_to_col = torch.where(won_col >= 0, won_col,
                             torch.where(evicted, -1, row_to_col))
    col_to_row = torch.where(got, winner_row, col_to_row)
    prices = torch.where(got, best_bid, prices)
    return prices, row_to_col, col_to_row


def _fb_round(carry, weights, theta, eps):
    """One auction round with an analytic private fallback column per row.

    The diagonal block of the augmented matrix is never contested, so it
    is a constant outside option worth `theta`: a row whose best real
    value (net of prices) is below theta takes it at once and for good
    (state -2); the others bid v_best - max(v_second, theta) + eps."""
    prices, row_to_col, col_to_row = carry
    unassigned = row_to_col == -1
    values = weights - prices[..., None, :]
    v_best, j_best = first_argmax(values, -1)
    v_second = _second_best(values, j_best)
    take_fb = unassigned & (theta >= v_best)
    bid = (prices.gather(-1, j_best)
           + (v_best - torch.clamp(v_second, min=theta)) + eps[:, None])
    prices, r2c, col_to_row = _column_side(
        unassigned & ~take_fb, j_best, bid, prices, row_to_col, col_to_row)
    return prices, torch.where(take_fb, -2, r2c), col_to_row


def _run_rounds(round_fn, carry, max_iters, pending):
    """UNROLLED_ROUNDS rounds, then more while `pending(row_to_col)` has a
    row in any scene and fewer than max_iters rounds ran.  A round changes
    nothing in a scene with no pending row (no row bids, so no column
    changes hands), so every scene's columns equal those of its own
    single-scene run."""
    for _ in range(UNROLLED_ROUNDS):
        carry = round_fn(carry)
    count("auction.rounds", UNROLLED_ROUNDS)
    i = UNROLLED_ROUNDS
    while i < max_iters:
        with wait("auction.converged"):
            more = bool(pending(carry[1]).any())
        if not more:
            break
        carry = round_fn(carry)
        count("auction.rounds")
        i += 1
    return carry


def _eps(weights: torch.Tensor, wmax: torch.Tensor) -> torch.Tensor:
    """Per-scene bid increment span / max(4096, 64 D) of weights [S, D, N]."""
    wmin = torch.clamp(weights.amin(dim=(-2, -1)), max=0.0)
    span = torch.clamp(wmax - wmin, min=1e-6)
    return span / max(4096.0, 64.0 * weights.shape[-2])


def _scenes(weights: torch.Tensor, solve, *args) -> torch.Tensor:
    """Run a scene-batched solver on [S, D, N] or a single [D, N]."""
    if weights.dim() == 2:
        return solve(weights[None], *args)[0]
    return solve(weights, *args)


def auction_lap_fallback(weights: torch.Tensor, theta: float,
                         max_iters: int = MAX_AUCTION_ROUNDS) -> torch.Tensor:
    """Auction on the SORT voting LP (real-column weights [S?, D, T], 0 =
    no edge) with private fallback columns.  Returns per row the column in
    the augmented convention.  eps is per scene, as under the JAX
    package's vmap.  A CUDA tensor launches the kernel; a CPU tensor runs
    `auction_lap_fallback_plain`."""
    if _device_kind(weights) == "cuda":
        return auction_fb_cuda(weights, theta, max_iters)
    return auction_lap_fallback_plain(weights, theta, max_iters)


def auction_lap_fallback_plain(weights: torch.Tensor, theta: float,
                               max_iters: int = MAX_AUCTION_ROUNDS
                               ) -> torch.Tensor:
    """The plain rounds of `auction_lap_fallback` on the weights' device:
    UNROLLED_ROUNDS rounds, then a host check (the wait
    `auction.converged`) before each further round."""
    return _scenes(weights, _auction_lap_fallback, theta, max_iters)


def _auction_lap_fallback(weights, theta, max_iters):
    s, d, t = weights.shape
    dev = weights.device
    eps = _eps(weights, torch.clamp(weights.amax(dim=(-2, -1)), min=theta))
    carry = (torch.zeros((s, t), dtype=weights.dtype, device=dev),
             torch.full((s, d), -1, dtype=torch.int64, device=dev),
             torch.full((s, t), -1, dtype=torch.int64, device=dev))
    _, row_to_col, _ = _run_rounds(
        lambda c: _fb_round(c, weights, theta, eps), carry, max_iters,
        lambda r2c: r2c == -1)
    rows = torch.arange(d, device=dev)
    return torch.where(row_to_col >= 0, d + row_to_col, rows)


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def f32(x: float) -> float:
    """x rounded to float32, as PyTorch rounds a Python number it compares
    with, clamps or divides a float32 tensor by (out of range: infinite)."""
    with np.errstate(over="ignore"):
        return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _plan(device: int, s: int, d: int, t: int) -> Tuple[int, int, int, int]:
    """(threads, lanes a row, storage, shared bytes) of the kernel at
    (s, d, t) on the card `device`: the library's `auction_fb_plan`."""
    from .._build import library

    plan = (ctypes.c_int * 4)()
    if library().auction_fb_plan(s, d, t, plan) != 0:
        raise ValueError(
            f"the auction kernel takes at most ~9,200 rows a scene (its "
            f"rows' state lives in shared memory); got D={d}; use "
            f"assignment='native' or 'hungarian'")
    return tuple(plan)


def auction_fb_cuda(weights: torch.Tensor, theta: float,
                    max_iters: int = MAX_AUCTION_ROUNDS,
                    row_valid: Optional[torch.Tensor] = None,
                    col_valid: Optional[torch.Tensor] = None,
                    scene_rounds: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """`auction_lap_fallback` of f32 CUDA weights [S?, D, T] in one launch
    of `auction_fb_kernel`; with the bool masks row_valid [S?, D] and
    col_valid [S?, T] the weights are `edges(weights, row_valid,
    col_valid)`, applied as the kernel loads them.  Writes each scene's
    rounds into `scene_rounds` (int32 [S?]) where given.  Adds one to
    `auction.launches` and the call's rounds to the device counter
    `auction.rounds`; never waits for the device."""
    if weights.dtype != torch.float32:
        raise TypeError(f"the auction kernel takes float32 weights, got "
                        f"{weights.dtype}")
    if weights.device.type != "cuda":
        raise ValueError(f"the auction kernel runs on a card, got weights "
                         f"on {weights.device}")
    if (row_valid is None) != (col_valid is None):
        raise ValueError("give both masks or neither")
    single = weights.dim() == 2
    w = weights[None] if single else weights
    if w.dim() != 3:
        raise ValueError(f"weights must be [S?, D, T], got "
                         f"{tuple(weights.shape)}")
    s, d, t = w.shape
    dev = w.device
    if min(d, t) < 1:
        raise ValueError(f"D={d}, T={t}: the auction needs a row and a "
                         "column")
    out = torch.empty((s, d), dtype=torch.int64, device=dev)
    if s == 0:
        return out
    w = w.contiguous()
    masks = []
    for m, n, name in ((row_valid, d, "row_valid"),
                       (col_valid, t, "col_valid")):
        if m is None:
            continue
        if m.dtype != torch.bool or m.device != dev:
            raise TypeError(f"{name} must be a bool tensor on {dev}")
        masks.append(torch.broadcast_to(m, (s, n)).contiguous())
    if scene_rounds is not None and (
            scene_rounds.dtype != torch.int32 or scene_rounds.numel() != s
            or not scene_rounds.is_contiguous()
            or scene_rounds.device != dev):
        raise ValueError("scene_rounds must be a contiguous int32 tensor "
                         "of S elements on the weights' card")
    from .._build import check, library

    lib = library()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    threads, lanes, storage, smem = _plan(index, s, d, t)
    scratch = (None if storage else torch.empty(
        (lib.auction_fb_scratch_bytes(s, t),), dtype=torch.uint8,
        device=dev))
    acc = device_counter("auction.rounds", dev, 3)
    vec = int(t % 4 == 0 and w.data_ptr() % 16 == 0)

    def ptr(x):
        return ctypes.c_void_p(None if x is None else x.data_ptr())

    rv, cv = masks if masks else (None, None)
    with torch.cuda.device(dev):
        code = lib.auction_fb_launch(
            ptr(w), ptr(rv), ptr(cv), ptr(out), ptr(scene_rounds), ptr(acc),
            ptr(scratch), s, d, t,
            min(max(UNROLLED_ROUNDS, int(max_iters)), 2 ** 31 - 1),
            UNROLLED_ROUNDS, f32(theta),
            f32(np.float32(1.0) / np.float32(max(4096.0, 64.0 * d))),
            threads, lanes, storage, smem, vec,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(code, "auction_fb_launch")
    count("auction.launches")
    return out[0] if single else out


def _auction_round(carry, weights, eps):
    """One Jacobi round: every unassigned row bids for its best column."""
    prices, row_to_col, col_to_row = carry
    unassigned = row_to_col < 0
    values = weights - prices[..., None, :]
    v_best, j_best = first_argmax(values, -1)
    v_second = _second_best(values, j_best)
    bid = prices.gather(-1, j_best) + (v_best - v_second) + eps[:, None]
    return _column_side(unassigned, j_best, bid, prices, row_to_col,
                        col_to_row)


def _fixup_unassigned(row_to_col: torch.Tensor,
                      col_to_row: torch.Tensor) -> torch.Tensor:
    """Give rows still unassigned after the round cap the free columns in
    order (the r-th such row the r-th free column; n-1 when none is
    left), so the result stays a matching.  Rows [S, D], columns [S, N]."""
    s, n = col_to_row.shape
    dev = col_to_row.device
    col_free = col_to_row < 0
    order = torch.cumsum(col_free.long(), -1) - 1
    row_un = row_to_col < 0
    rank = torch.cumsum(row_un.long(), -1) - 1
    table = torch.full((s, n + 1), n - 1, dtype=torch.int64, device=dev)
    table.scatter_(-1, torch.where(col_free, order, n),
                   torch.arange(n, device=dev).expand(s, n))
    fill = table.gather(-1, torch.clamp(rank, 0, n - 1))
    return torch.where(row_un, fill, row_to_col)


def auction_lap(weights: torch.Tensor,
                max_iters: int = MAX_AUCTION_ROUNDS) -> torch.Tensor:
    """Maximisation LAP on weights[S?, D, N] (N >= D): one forward-auction
    phase from zero prices.  Returns the column per row [S?, D]."""
    d, n = weights.shape[-2:]
    if n < d:
        raise ValueError("need at least as many columns as rows")
    return _scenes(weights, _auction_lap, max_iters)


def _auction_lap(weights, max_iters):
    s, d, n = weights.shape
    dev = weights.device
    eps = _eps(weights, weights.amax(dim=(-2, -1)))
    carry = (torch.zeros((s, n), dtype=weights.dtype, device=dev),
             torch.full((s, d), -1, dtype=torch.int64, device=dev),
             torch.full((s, n), -1, dtype=torch.int64, device=dev))
    _, row_to_col, col_to_row = _run_rounds(
        lambda c: _auction_round(c, weights, eps), carry, max_iters,
        lambda r2c: r2c < 0)
    return _fixup_unassigned(row_to_col, col_to_row)


def _hungarian_np(weights: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    d, n = weights.shape
    rows, cols = linear_sum_assignment(weights, maximize=True)
    out = np.full((d,), -1, np.int64)
    out[rows] = cols
    # scipy assigns every row when n >= d; guard anyway
    if (out < 0).any():
        free = sorted(set(range(n)) - set(out[out >= 0].tolist()))
        out[out < 0] = np.asarray(free[: (out < 0).sum()], np.int64)
    return out


def hungarian_host(weights: torch.Tensor) -> torch.Tensor:
    """Exact Hungarian on the host, one scene after another for [S, D, N]
    (as the JAX package's sequential callback); the columns come back to
    the weights' device."""
    with wait("assignment.to_host"):
        w = weights.detach().cpu().numpy()
    out = (_hungarian_np(w) if w.ndim == 2
           else np.stack([_hungarian_np(x) for x in w]))
    with wait("assignment.to_device"):
        return torch.from_numpy(out).to(weights.device)


def native_host(weights: torch.Tensor) -> torch.Tensor:
    """Exact C++ solver on the host for [S?, D, N]: every scene in one call
    (`lap_max_batch`); the columns come back to the weights' device."""
    from .lap import lap_max_batch

    with wait("assignment.to_host"):
        w = weights.detach().cpu().numpy()
    out = lap_max_batch(w if w.ndim == 3 else w[None])
    out = out if w.ndim == 3 else out[0]
    with wait("assignment.to_device"):
        return torch.from_numpy(out.astype(np.int64)).to(weights.device)


def resolve_backend(backend: str, device: torch.device) -> str:
    """'auto' -> the auction on CUDA, scipy's exact Hungarian on the CPU.

    The JAX package's 'auto' takes its C++ solver on the CPU when it is
    built.  Both host solvers are exact, but they break ties between equal
    optima differently, so moving 'auto' to 'native' here would move
    existing CPU results for no gain in semantics; 'native' is the
    caller's explicit choice."""
    if backend != "auto":
        return backend
    return "auction" if device.type == "cuda" else "hungarian"


def solve_lap(weights: torch.Tensor, backend: str = "auction") -> torch.Tensor:
    if backend == "auction":
        return auction_lap(weights)
    if backend == "hungarian":
        return hungarian_host(weights)
    if backend == "native":
        return native_host(weights)
    raise ValueError(f"unknown assignment backend: {backend}")


def edges(metric: torch.Tensor, row_valid: torch.Tensor,
          col_valid: torch.Tensor) -> torch.Tensor:
    """The metric on valid (row, column) pairs, 0 (no edge) elsewhere.  A
    NaN weight is no edge either: a valid zero-height detection opens a
    track whose Kalman state is NaN, and a Mahalanobis weight against it
    passes the distance gates (every comparison with NaN is false).  The
    reference's host engine drops such a pair (`w > 0` is false), so every
    solver here gets a finite matrix and the same ids."""
    ok = (row_valid[..., :, None] & col_valid[..., None, :]
          & ~torch.isnan(metric))
    return torch.where(ok, metric, 0.0)


def augment_with_threshold(metric: torch.Tensor, threshold: float,
                           row_valid: torch.Tensor,
                           col_valid: torch.Tensor) -> torch.Tensor:
    """The SORT voting matrix [D, D+T]: the threshold on the diagonal (for
    padding rows too: their row is 0 elsewhere and the diagonal column is
    private, so the optimum parks them there), the masked metric beside
    it."""
    d = metric.shape[-2]
    body = edges(metric, row_valid, col_valid)
    eye = torch.eye(d, dtype=torch.bool, device=metric.device)
    diag = torch.where(eye, threshold, 0.0).to(metric.dtype)
    return torch.cat([diag.expand(*body.shape[:-1], d), body], dim=-1)


def solve_voting(metric: torch.Tensor, threshold: float,
                 row_valid: torch.Tensor, col_valid: torch.Tensor,
                 backend: str) -> torch.Tensor:
    """SORT voting on metric [S?, D, T]: per-row column in the augmented
    convention.  The auction never builds the [D, D] diagonal block; the
    host solvers solve the augmented matrix."""
    if backend == "auction":
        if _device_kind(metric) == "cuda":
            return auction_fb_cuda(metric, threshold, row_valid=row_valid,
                                   col_valid=col_valid)
        return auction_lap_fallback_plain(
            edges(metric, row_valid, col_valid), threshold)
    return solve_lap(augment_with_threshold(metric, threshold, row_valid,
                                            col_valid), backend)
