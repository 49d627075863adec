"""Fused SORT frame: the whole step for a chunk of C frames per launch
(mirrors `similari_tpu/ops/pallas_sort.py`).

`fused_sort_chunk` launches the CUDA kernel `fused_sort_kernel`
(`csrc/fused_track.cu`) for CUDA tensors and runs its plain PyTorch version,
`fused_sort_chunk_plain`, for CPU tensors.  Both compute, per frame: aligned
IoU x confidence weights with compatibility gating, the forward auction on
the augmented `[D, D+T]` matrix, free-slot allocation, the Kalman
predict/update, the state write (dropped on overflow) and the overflow flag.
The kernel runs the chunk on one thread-block cluster of 8 blocks, each
holding a column slice of the weights and of the state
(`tests/kernel_replay.py` replays its split of the auction and the slot
allocation on the CPU).

Scope, as the reference kernel's: method = IoU on axis-aligned boxes, no
spatio-temporal constraints, history depth 1.  Shapes: at most MAX_ROWS
rows per frame, and a block's shared arrays within MAX_SMEM with every
slice in device memory (`check_sort_shape`, before any launch on every
device).

The state travels as a tuple (see `state_to_tuple`):
(mean_pos, mean_vel, cpp, cpv, cvv, pred_box, obs_box, conf, active i32,
last_epoch, length, track_id, next_id[1]).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from .assignment import MAX_AUCTION_ROUNDS, NEG, first_argmax
from .kalman import KalmanSpec, KalmanState
from ..trackers.sort_step import SortConfig
from ..trackers.state import SortState
from ..utils.profiling import count, span, spanned

_F32, _I32 = torch.float32, torch.int32

SortTuple = Tuple[torch.Tensor, ...]

# the phases of a frame in `fused_sort_kernel`, in order; a profiled launch
# stamps the start of the frame and the end of each into an int64
# [C, PROF_WIDTH] buffer (`csrc/fused_track.cu::SS_*`), and the frame's
# cluster barriers into its last column
PHASES = ("rows and tracks", "weights", "span", "auction", "match", "slots",
          "Kalman", "state write")
PROF_WIDTH = len(PHASES) + 2
# where a block keeps its data (`fused_sort_chunk.plan["storage"]`, bits:
# 4 the auction's column arrays, 2 its state slice, 1 its W slice in shared
# memory; the rest in device memory)
STORAGE = {7: "columns, state and W in shared memory",
           6: "columns and state in shared memory, W in device memory",
           4: "columns in shared memory, state and W in device memory",
           0: "all in device memory"}
# the fused kernels' limits (`csrc/fused_track.cu`, `.cuh`): a frame's rows
# (`MAX_ROWS`), a block's shared memory on sm_90; the SORT cluster's
# blocks and their threads
MAX_ROWS = 1024
MAX_SMEM = 232448
SORT_CLUSTER, SORT_THREADS = 8, 512
STEP_HINT = ('; run the general step instead (engine="step" in '
             "eval/mot.py's runners)")


def carve_bytes(counts) -> int:
    """Shared bytes that `Carve::take` (`csrc/fused_track.cu`) hands out
    for arrays of 4-byte items, or (count, item bytes) pairs, in order,
    each from a 16-byte boundary."""
    off = 0
    for c in counts:
        n, size = c if isinstance(c, tuple) else (c, 4)
        off = ((off + 15) & ~15) + n * size
    return off


def sort_smem_bytes(d: int, t: int, storage: int) -> int:
    """Shared bytes per block of `SortSmem::carve` at D = d rows, T = t
    slots and the storage bits (`STORAGE`)."""
    tc = -(-t // SORT_CLUSTER)
    counts = [5 * d, 5 * d] + [d] * 8 + [2 * d, 2, (2 * d, 16)]
    if storage & 4:
        counts += [d + t, d + t, (d + t, 8)]
    counts += [tc, 5 * tc, tc, tc, tc, tc, 2, SORT_CLUSTER, 2, SORT_CLUSTER,
               32, 32]
    if storage & 2:
        counts += [5 * tc] * 7 + [tc] * 5
    if storage & 1:
        counts += [d * tc]
    return carve_bytes(counts)


def sort_storage(d: int, t: int):
    """(storage, shared bytes per block) that `sort_storage` in
    `csrc/fused_track.cu` chooses: the first of 7, 6, 4, 0 that fits;
    storage -1 (with the bytes of 0) when none fits."""
    for s in (7, 6, 4, 0):
        nbytes = sort_smem_bytes(d, t, s)
        if nbytes <= MAX_SMEM:
            return s, nbytes
    return -1, nbytes


def check_sort_shape(d: int, t: int):
    """Raise ValueError, before any launch and alike on every device, for
    a shape `fused_sort_kernel` does not take: more than MAX_ROWS rows per
    frame, or a block's shared arrays past MAX_SMEM with every slice in
    device memory.  Returns `sort_storage(d, t)`."""
    if d > MAX_ROWS:
        raise ValueError(f"the fused SORT kernel takes at most {MAX_ROWS} "
                         f"rows per frame (one per thread), got D={d}"
                         + STEP_HINT)
    storage, nbytes = sort_storage(d, t)
    if storage < 0:
        raise ValueError(f"the fused SORT kernel's shared arrays at D={d}, "
                         f"T={t} take {nbytes} bytes per block, past the "
                         f"{MAX_SMEM} bytes a block may use" + STEP_HINT)
    return storage, nbytes


# ---------------------------------------------------------------------------
# plain PyTorch pieces shared with ops/fused_visual.py
# ---------------------------------------------------------------------------

def forward_auction_plain(A: torch.Tensor, dvalid: torch.Tensor):
    """Jacobi forward auction on the augmented weights A[D, N] (the first D
    columns are the new-track diagonal).  Returns (r2c[D], rounds, bids):
    the column of each row (padded rows stay at 0), the rounds run and the
    bids made.  Ties go to the lowest column and the lowest row; outbid
    owners return to the pool; at most 3000 rounds."""
    d, n = A.shape
    dev = A.device
    span = torch.clamp(A.max(), min=1e-6)
    eps = span / max(4096.0, 64.0 * d)
    rows = torch.arange(d, device=dev)
    cols = torch.arange(n, device=dev)
    prices = torch.zeros(n, dtype=_F32, device=dev)
    r2c = torch.where(dvalid, -1, 0).to(torch.int64)
    c2r = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rounds = bids = 0
    while rounds < MAX_AUCTION_ROUNDS:
        bidding = r2c < 0
        nb = int(bidding.sum())
        if nb == 0:
            break
        rounds += 1
        bids += nb
        values = A - prices
        v1, jbest = first_argmax(values, 1)
        v2 = values.index_put((rows, jbest),
                              torch.full((d,), NEG, dtype=_F32, device=dev)
                              ).max(dim=1).values
        bid = prices[jbest] + (v1 - v2) + eps
        bids_m = torch.full((d, n), NEG, dtype=_F32, device=dev)
        bids_m[rows[bidding], jbest[bidding]] = bid[bidding]
        best, winner = first_argmax(bids_m, 0)
        got = best > NEG * 0.5
        evicted = c2r[got & (c2r >= 0)]
        r2c[evicted] = -1
        c2r = torch.where(got, winner, c2r)
        prices = torch.where(got, best, prices)
        r2c[winner[got]] = cols[got]
    return r2c, rounds, bids


def sanitize_boxes(box: torch.Tensor, dvalid: torch.Tensor) -> torch.Tensor:
    """Padded rows may carry zero boxes; a zero height makes the Kalman
    update divide 0/0, so they become the unit box (0, 0, 0, 1, 1)."""
    vf = dvalid.to(_F32)[:, None]
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], dtype=_F32,
                        device=box.device)
    return box * vf + (1.0 - vf) * unit


def aligned_iou(box: torch.Tensor, pred: torch.Tensor):
    """(iou, intersection) of detections [D, 5] x predicted tracks [T, 5]."""
    aw = box[:, 3] * box[:, 4]
    tw = pred[:, 3] * pred[:, 4]
    ix = (torch.minimum(box[:, 0:1] + aw[:, None] * 0.5,
                        (pred[:, 0] + tw * 0.5)[None, :])
          - torch.maximum(box[:, 0:1] - aw[:, None] * 0.5,
                          (pred[:, 0] - tw * 0.5)[None, :]))
    iy = (torch.minimum(box[:, 1:2] + box[:, 4:5] * 0.5,
                        (pred[:, 1] + pred[:, 4] * 0.5)[None, :])
          - torch.maximum(box[:, 1:2] - box[:, 4:5] * 0.5,
                          (pred[:, 1] - pred[:, 4] * 0.5)[None, :]))
    inter = torch.where((ix > 0) & (iy > 0), ix * iy, 0.0)
    union = ((aw * box[:, 4])[:, None] + (tw * pred[:, 4])[None, :] - inter)
    return inter / torch.where(inter > 0, union, 1.0), inter


def augmented(W: torch.Tensor, dvalid: torch.Tensor, thr: float) -> torch.Tensor:
    """[D, D+T]: the new-track diagonal (thr on valid rows) beside W."""
    d = W.shape[0]
    eye = torch.eye(d, dtype=torch.bool, device=W.device)
    diag = torch.where(eye & dvalid[:, None], thr, 0.0).to(_F32)
    return torch.cat([diag, W], dim=1)


def allocate_slots(is_new: torch.Tensor, matched: torch.Tensor,
                   tgt: torch.Tensor, free: torch.Tensor):
    """The r-th new detection takes the r-th free slot (slot order); rows
    without one get T-1 and never write.  Returns (slot, new_rank
    inclusive, n_new, overflow)."""
    t = free.shape[0]
    new_rank = torch.cumsum(is_new.to(torch.int64), 0)
    flist = torch.cat([torch.nonzero(free).flatten(),
                       torch.tensor([t - 1], device=free.device)])
    n_free = flist.shape[0] - 1
    has = (new_rank >= 1) & (new_rank <= n_free)
    new_slot = flist[torch.where(has, new_rank - 1, n_free)]
    slot = torch.where(matched, tgt, new_slot)
    n_new = new_rank[-1]
    return slot, new_rank, n_new, n_new > n_free


def kalman_rows(spec: KalmanSpec, st: SortTuple, slot, matched, box):
    """Gather the matched tracks' filters (or initiate), predict, update."""
    init = spec.initiate(box)
    prev = KalmanState(*(
        torch.where(matched[:, None], st[i][slot], getattr(init, name))
        for i, name in enumerate(("mean_pos", "mean_vel", "cpp", "cpv",
                                  "cvv"))))
    return spec.update(spec.predict(prev), box, s_floor=1e-30)


def write_rows(st: list, w, sl, u: KalmanState, box, conf, epoch,
               new_len, new_ids) -> None:
    """Scatter the updated rows `w` (a bool mask) into their slots."""
    for i, v in enumerate((u.mean_pos, u.mean_vel, u.cpp, u.cpv, u.cvv,
                           u.mean_pos, box)):
        st[i][sl] = v[w]
    st[7][sl] = conf[w]
    st[8][sl] = 1
    st[9][sl] = epoch
    st[10][sl] = new_len[w].to(_I32)
    st[11][sl] = new_ids[w].to(_I32)


# ---------------------------------------------------------------------------
# the chunk: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def check_sort_scope(cfg: SortConfig) -> None:
    if cfg.method != "iou" or cfg.oriented or cfg.constraints:
        raise NotImplementedError(
            "the fused SORT kernel covers aligned-IoU matching without "
            "constraints; Mahalanobis, oriented boxes and constraints run "
            "on the general step (trackers/sort_step.py::sort_scan)")


def fused_sort_chunk_plain(cfg: SortConfig, state: SortTuple, box, conf,
                           valid, epoch0: int):
    """Plain PyTorch version of the fused SORT chunk (same outputs as
    `fused_sort_chunk`), on any device."""
    st = [x.clone() for x in state]
    c, d = box.shape[:2]
    t = st[0].shape[0]
    thr = cfg.iou_threshold
    spec = cfg.kalman_spec
    rows = torch.arange(d, device=box.device)
    ids, slots, preds, ovfs, stats = [], [], [], [], []
    for s in range(c):
        epoch = epoch0 + s
        dvalid = valid[s] > 0
        bx = sanitize_boxes(box[s], dvalid)
        active = st[8] > 0
        compat = active & ((epoch - st[9]) <= cfg.max_idle_epochs)
        if cfg.recycle_idle:
            active = compat
        iou, inter = aligned_iou(bx, st[5])
        m = iou * torch.clamp(conf[s], min=cfg.min_confidence)[:, None]
        W = torch.where(compat[None, :] & (inter > 0) & (m >= thr), m, 0.0)
        A = augmented(W, dvalid, thr)
        r2c, rounds, bids = forward_auction_plain(A, dvalid)
        tgt = torch.clamp(r2c - d, 0, t - 1)
        matched = dvalid & (r2c >= d) & (W[rows, tgt] >= thr)
        is_new = dvalid & ~matched
        slot, new_rank, n_new, overflow = allocate_slots(
            is_new, matched, tgt, ~active)
        u = kalman_rows(spec, st, slot, matched, bx)
        new_len = torch.where(matched, st[10][slot] + 1, 1)
        new_ids = torch.where(matched, st[11][slot], st[12][0] + new_rank)
        if cfg.recycle_idle:
            st[8] = active.to(_I32)
        if not bool(overflow):
            w = dvalid
            write_rows(st, w, slot[w], u, bx, conf[s], epoch, new_len,
                       new_ids)
        st[12] = st[12] + n_new.to(_I32)
        ids.append(new_ids.to(_I32))
        slots.append(slot.to(_I32))
        preds.append(u.mean_pos)
        ovfs.append(overflow)
        stats.append(torch.tensor([rounds, bids, 0], dtype=_I32))
    return (tuple(st), torch.stack(ids), torch.stack(slots),
            torch.stack(preds), torch.stack(ovfs),
            torch.stack(stats).to(box.device))


def check_chunk_inputs(state, box, conf, valid, t_shapes, extra=()):
    """Raise on shapes, dtypes or devices the kernels do not take (`extra`:
    further per-frame inputs, checked for their device here)."""
    if box.dim() != 3 or box.shape[2] != 5:
        raise ValueError(f"box must be [C, D, 5], got {tuple(box.shape)}")
    c, d = box.shape[:2]
    if conf.shape != (c, d) or valid.shape != (c, d):
        raise ValueError("conf and valid must be [C, D]")
    if len(state) != len(t_shapes):
        raise ValueError(f"state has {len(state)} entries, expected "
                         f"{len(t_shapes)}")
    dev = box.device
    for x in (box, conf, valid, *extra, *state):
        if x.device != dev:
            raise ValueError("all tensors must be on one device")
    if box.dtype != _F32 or conf.dtype != _F32:
        raise TypeError("box and conf must be float32")
    for x, (shape, dtype) in zip(state, t_shapes):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"state entry {tuple(x.shape)} {x.dtype}, expected "
                f"{shape} {dtype}")


def check_prof(prof, box, width):
    """Raise unless `prof` is None or a contiguous int64 [C, width] tensor
    on the inputs' CUDA device."""
    if prof is not None and (box.device.type != "cuda"
                             or prof.shape != (box.shape[0], width)
                             or prof.dtype != torch.int64
                             or prof.device != box.device
                             or not prof.is_contiguous()):
        raise ValueError(f"prof must be a contiguous int64 [{box.shape[0]}, "
                         f"{width}] tensor on the inputs' CUDA device")


def pointers(*tensors):
    """Device addresses for the C launchers."""
    return [ctypes.c_void_p(x.data_ptr()) for x in tensors]


def sort_state_shapes(t: int):
    f5, f1, i1 = ((t, 5), _F32), ((t,), _F32), ((t,), _I32)
    return [f5] * 7 + [f1] + [i1] * 4 + [((1,), _I32)]


@spanned("fused_sort_chunk")
def fused_sort_chunk(cfg: SortConfig, state: SortTuple, box: torch.Tensor,
                     conf: torch.Tensor, valid: torch.Tensor, epoch0: int,
                     prof=None):
    """C frames of SORT from `state` (not modified).

    box f32[C,D,5], conf f32[C,D], valid bool/int[C,D]; frame s runs at
    epoch `epoch0 + s`.  Returns (state', ids i32[C,D], slots i32[C,D],
    pred f32[C,D,5], overflow bool[C], stats i32[C,3]) where stats holds
    the auction rounds, the bids made and (0) per frame.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    `prof`, an int64 [C, PROF_WIDTH] CUDA tensor, receives the kernel's
    phase stamps (ns of the device's global timer) and cluster barriers.
    A launch records its plan in `fused_sort_chunk.plan`: cluster size,
    threads per block, storage (`STORAGE`) and shared bytes per block.
    """
    check_sort_scope(cfg)
    valid = valid.to(_I32)
    check_chunk_inputs(state, box, conf, valid,
                       sort_state_shapes(state[0].shape[0]))
    check_prof(prof, box, PROF_WIDTH)
    c, d = box.shape[:2]
    t = state[0].shape[0]
    storage, smem_bytes = check_sort_shape(d, t)
    if box.device.type == "cpu":
        return fused_sort_chunk_plain(cfg, state, box, conf, valid, epoch0)
    if box.device.type != "cuda":
        raise ValueError(f"unsupported device {box.device}")
    from .._build import check, library

    lib = library()
    box, conf, valid = box.contiguous(), conf.contiguous(), valid.contiguous()
    with span("fused_sort.clone"):
        st = tuple(x.contiguous().clone() for x in state)  # updated in place
    dev = box.device
    ids = torch.empty((c, d), dtype=_I32, device=dev)
    slots = torch.empty((c, d), dtype=_I32, device=dev)
    pred = torch.empty((c, d, 5), dtype=_F32, device=dev)
    ovf = torch.empty((c,), dtype=_I32, device=dev)
    stats = torch.empty((c, 3), dtype=_I32, device=dev)
    # device-memory scratch only for what the storage keeps out of shared
    # memory: the W slices, the column arrays ([G, 4 (D+T)] words)
    W = None if storage & 1 else torch.empty((d, t), dtype=_F32, device=dev)
    cols = (None if storage & 4 else
            torch.empty((SORT_CLUSTER, 4 * (d + t)), dtype=_I32, device=dev))
    pw, vw = cfg.position_weight, cfg.velocity_weight
    # the launch and its attributes
    with span("fused_sort.launch"), torch.cuda.device(dev):
        code = lib.fused_sort_launch(
            *pointers(box, conf, valid, *st, ids, slots, pred, ovf, stats),
            *(None if x is None else x.data_ptr() for x in (W, cols)), c, d,
            t, int(epoch0), cfg.max_idle_epochs, int(cfg.recycle_idle),
            cfg.iou_threshold, cfg.min_confidence,
            2.0 * pw, 1.0 * pw, 10.0 * vw, 1.0 * vw,
            None if prof is None else prof.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        check(code, "fused_sort_launch")
    fused_sort_chunk.plan = dict(cluster=SORT_CLUSTER, threads=SORT_THREADS,
                                 storage=storage, smem_bytes=smem_bytes)
    count("fused_sort.launches")
    return st, ids, slots, pred, ovf > 0, stats


fused_sort_chunk.plan = None


# ---------------------------------------------------------------------------
# state <-> tuple and the scan of chunks
# ---------------------------------------------------------------------------

def state_to_tuple(state: SortState) -> SortTuple:
    return (
        state.kf.mean_pos, state.kf.mean_vel, state.kf.cpp, state.kf.cpv,
        state.kf.cvv, state.pred_box, state.obs_box, state.conf,
        state.active.to(_I32), state.last_epoch, state.length,
        state.track_id, state.next_id.reshape(1).to(_I32),
    )


def tuple_to_state(tup: SortTuple, template: SortState) -> SortState:
    (mp, mv, cpp, cpv, cvv, pred, obs, tconf, active, last, length, tid,
     nid) = tup
    return dataclasses.replace(
        template,
        kf=KalmanState(mp, mv, cpp, cpv, cvv),
        pred_box=pred, obs_box=obs, conf=tconf,
        active=active > 0, last_epoch=last, length=length, track_id=tid,
        hist_obs=obs[:, None, :], hist_pred=pred[:, None, :],
        hist_conf=tconf[:, None],
        next_id=nid.reshape(()),
    )


def fused_sort_scan(cfg: SortConfig, state: SortState, det_box, det_conf,
                    det_valid, epoch0: int, chunk: int):
    """Chunks of `chunk` frames through `fused_sort_chunk`, epochs
    consecutive from `epoch0`.  Returns (state', (ids, slots, pred,
    overflow)) with [S, D, ...] outputs."""
    if state.history != 1:
        raise NotImplementedError(
            "the fused kernel keeps history depth 1; deeper histories run "
            "on the general step (trackers/sort_step.py::sort_scan)")
    steps = det_box.shape[0]
    if steps % chunk:
        raise ValueError("steps must be a multiple of the chunk size")
    tup = state_to_tuple(state)
    outs = []
    for c0 in range(0, steps, chunk):
        sl = slice(c0, c0 + chunk)
        tup, *o = fused_sort_chunk(cfg, tup, det_box[sl], det_conf[sl],
                                   det_valid[sl], epoch0 + c0)
        outs.append(o[:4])
    ids, slots, pred, ovf = (torch.cat(x) for x in zip(*outs))
    return tuple_to_state(tup, state), (ids, slots, pred, ovf)
