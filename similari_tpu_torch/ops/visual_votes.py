"""Gallery votes and the greedy BestFit claim of the general VisualSORT step
(the part of `similari_tpu/trackers/visual_step.py::_visual_step_impl`
from the gallery product to the claimed tracks).

    (t1, has_any, wins, claimed) = visual_best_fit(dot, qn, gn, ...)

From the product dot [S, D, T*K] and the norms of `ops/distances.py::gram`:
each gallery lane (d, t, k) votes when its distance passes the threshold
and the gates (the detection's feature gate, compat [S, D, T], the track's
maturity, the lane's validity); the best-fit weight of (d, t) sums
max_dist - distance over its voting lanes, max_dist the scene's largest
voting distance; a detection with at least `min_votes` votes is eligible.
Then the greedy claim in closed form: t1[d] is d's heaviest track,
has_any[d] whether d is eligible for any track, wins[d] whether d is
also t1[d]'s heaviest detection, and claimed[t] whether some detection
wins t (t's heaviest detection wins it).  First-max argmaxes: exact copies
of a detection tie, and the lowest row must win.

`visual_best_fit` launches the CUDA kernel `visual_votes_kernel`
(`csrc/visual_votes.cu`, counter `visual_votes.launches`) for CUDA tensors
and runs its plain PyTorch version, `visual_best_fit_plain`, for CPU
tensors.  The two are bit-equal; the kernel writes no [S, D, T, K] or
[S, D, T] tensor and never waits for the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count
from . import assignment as asg
from . import distances as dst

KINDS = ("euclidean", "cosine")
_COLUMNS = 1  # the plan's storage bit: column keys in shared memory


def votes_and_weight(dot, qn, gn, use_gate, compat, track_gate, feat_valid,
                     kind: str, threshold: float):
    """(votes [S, D, T], weight [S, D, T]): the gallery lanes that pass the
    metric and the gates, and the best-fit weight sum(max_dist - d) over
    them, summed in lane order."""
    s, d = dot.shape[:2]
    t, k = feat_valid.shape[-2:]
    m = dst.from_gram(dot, qn, gn, kind).reshape(s, d, t, k)
    if kind == "euclidean":
        w, ok = m, m <= threshold
    else:
        w, ok = 1.0 - m, m >= threshold
    valid = (use_gate[..., :, None, None] & compat[..., None]
             & track_gate[..., None, :, None]
             & feat_valid[..., None, :, :] & ok)
    votes = valid.sum(-1)
    max_dist = torch.where(valid, w, asg.NEG).amax(dim=(-3, -2, -1))
    terms = torch.where(valid, max_dist[:, None, None, None] - w, 0.0)
    weight = torch.zeros_like(terms[..., 0])
    for lane in range(k):  # lane order, as the reference sums
        weight = weight + terms[..., lane]
    return votes, weight


def best_fit(votes, weight, det_valid, min_votes: int):
    """The greedy claim on [S?, D, T] votes and weights: (t1, has_any,
    wins, claimed)."""
    eligible = (votes >= min_votes) & det_valid[..., None]
    return claim(torch.where(eligible, weight, asg.NEG), eligible)


def claim(w, eligible):
    """The greedy best-fit claim in closed form on the weights w [S?, D, T]
    (NEG where not eligible): each row's best track t1, whether it has
    any, whether it wins t1 (it is t1's heaviest row), and the tracks
    claimed so."""
    _, t1 = asg.first_argmax(w, -1)  # [S?, D] best track per candidate
    has_any = eligible.any(-1)
    _, best_query = asg.first_argmax(w, -2)  # [S?, T] heaviest candidate
    rows = torch.arange(w.shape[-2], device=w.device)
    cols = torch.arange(w.shape[-1], device=w.device)
    wins = has_any & (best_query.gather(-1, t1) == rows)
    # a winner d of track t is t's heaviest candidate
    claimed = (wins.gather(-1, best_query)
               & (t1.gather(-1, best_query) == cols))
    return t1, has_any, wins, claimed


def visual_best_fit_plain(dot, qn, gn, use_gate, compat, track_gate,
                          feat_valid, det_valid, kind: str, threshold: float,
                          min_votes: int):
    """Plain PyTorch version of the kernel."""
    votes, weight = votes_and_weight(dot, qn, gn, use_gate, compat,
                                     track_gate, feat_valid, kind, threshold)
    return best_fit(votes, weight, det_valid, min_votes)


def _check(dot, qn, gn, use_gate, compat, track_gate, feat_valid,
           det_valid, kind):
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    if feat_valid.dim() != 3 or dot.dim() != 3:
        raise ValueError(f"dot must be [S, D, T*K] and feat_valid [S, T, K], "
                         f"got {tuple(dot.shape)} and "
                         f"{tuple(feat_valid.shape)}")
    s, t, k = feat_valid.shape
    d = dot.shape[1]
    if min(s, d, t, k) < 1:
        raise ValueError(f"S={s}, D={d}, T={t}, K={k}: every axis needs a "
                         "row, slot or lane")
    want = {"dot": (dot, (s, d, t * k)), "qn": (qn, (s, d)),
            "gn": (gn, (s, t * k)), "use_gate": (use_gate, (s, d)),
            "compat": (compat, (s, d, t)), "track_gate": (track_gate, (s, t)),
            "det_valid": (det_valid, (s, d))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(x.shape)}")
    for name in ("dot", "qn", "gn"):
        if want[name][0].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    for x, name in ((use_gate, "use_gate"), (compat, "compat"),
                    (track_gate, "track_gate"), (feat_valid, "feat_valid"),
                    (det_valid, "det_valid")):
        if x.dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    devices = {x.device for x in (dot, qn, gn, use_gate, compat, track_gate,
                                  feat_valid, det_valid)}
    if len(devices) != 1:
        raise ValueError("every input must be on one device")


@functools.lru_cache(maxsize=None)
def _plan(device: int, s: int, d: int, t: int):
    """(cluster size, storage bits, shared bytes a block) of a launch at
    (s, d, t) on the card `device`: the library's `visual_votes_plan`
    without column-key scratch where one fits, else with it."""
    from .._build import check, library

    lib = library()
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        if lib.visual_votes_plan(s, d, t, 0, plan) != 0:
            check(lib.visual_votes_plan(s, d, t, 1, plan),
                  "visual_votes_plan")
    return tuple(plan)


def visual_best_fit(dot, qn, gn, use_gate, compat, track_gate, feat_valid,
                    det_valid, kind: str, threshold: float, min_votes: int):
    """(t1 int64 [S, D], has_any [S, D], wins [S, D], claimed [S, T]) from
    dot f32 [S, D, T*K], qn [S, D], gn [S, T*K] (`ops/distances.py::gram`
    of the same `kind`) and the bool gates use_gate [S, D], compat
    [S, D, T], track_gate [S, T], feat_valid [S, T, K], det_valid [S, D].
    CUDA tensors launch the kernel (no host sync); CPU tensors run
    `visual_best_fit_plain`."""
    _check(dot, qn, gn, use_gate, compat, track_gate, feat_valid, det_valid,
           kind)
    s, d = dot.shape[:2]
    t = feat_valid.shape[1]
    dev = dot.device
    if dev.type == "cpu":
        return visual_best_fit_plain(dot, qn, gn, use_gate, compat,
                                     track_gate, feat_valid, det_valid, kind,
                                     threshold, min_votes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .._build import check, library

    lib = library()
    dot, qn, gn = dot.contiguous(), qn.contiguous(), gn.contiguous()
    use_gate, track_gate = use_gate.contiguous(), track_gate.contiguous()
    feat_valid, det_valid = feat_valid.contiguous(), det_valid.contiguous()
    if compat.stride(-1) != 1:  # a broadcast row axis (stride 0) is kept
        compat = compat.contiguous()
    t1 = torch.empty((s, d), dtype=torch.int64, device=dev)
    has_any = torch.empty((s, d), dtype=torch.bool, device=dev)
    wins = torch.empty((s, d), dtype=torch.bool, device=dev)
    claimed = torch.empty((s, t), dtype=torch.bool, device=dev)
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (
        dot, qn, gn, use_gate, compat, track_gate, feat_valid, det_valid,
        t1, has_any, wins, claimed)]
    k = feat_valid.shape[2]
    index = torch.cuda.current_device() if dev.index is None else dev.index
    cluster, storage, smem = _plan(index, s, d, t)
    # column keys that fit nowhere in shared memory go to device scratch
    colkey = (None if storage & _COLUMNS
              else torch.empty((s, t), dtype=torch.int64, device=dev))
    with torch.cuda.device(dev):
        code = lib.visual_votes_launch(
            *ptr, ctypes.c_void_p(None if colkey is None
                                  else colkey.data_ptr()),
            compat.stride(0), compat.stride(1), s, d, t, k,
            KINDS.index(kind), int(min_votes), asg.f32(threshold), cluster,
            storage, smem,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(code, "visual_votes_launch")
    count("visual_votes.launches")
    return t1, has_any, wins, claimed
