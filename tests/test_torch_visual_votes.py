"""The gallery votes and BestFit claim of the general VisualSORT step
(`ops/visual_votes.py`) on the CPU.

The plain version, which the CUDA kernel is held to bit for bit on the
card (tests/test_torch_cuda.py), must equal the composition the step is
built from: the distance matrices in the gram form, the gates and votes,
the scene's largest voting distance, the lane sums, two first-max
argmaxes, and the claimed tracks written by `ops/merge.py::written`.  All
four outputs are compared exactly, on random scenes with exact ties, NaN
features, overflowing norms, empty scenes and scenes where nothing votes.
"""

import numpy as np
import pytest
import torch

from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.ops import merge as mrg
from similari_tpu_torch.ops import visual_votes as vv
from similari_tpu_torch.utils import profiling

from torch_parity import VOTE_CASES, one_cpu_thread, votes_args, votes_inputs

one_cpu_thread()

CPU = torch.device("cpu")
NEG = -1e30


def _composition(inputs, kind, precision, min_votes):
    """(t1, has_any, wins, claimed) composed of whole-tensor ops from the
    features, as the step composed them."""
    q, g, use_gate, compat, track_gate, feat_valid, det_valid, thr = (
        torch.tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
        else x for x in inputs)
    s, d, f = q.shape
    t, k = g.shape[1:3]
    if precision == "bf16":
        q, g = q.to(torch.bfloat16), g.to(torch.bfloat16)
    qf, gf = q.float(), g.reshape(s, t * k, f).float()
    dot = torch.matmul(qf, gf.transpose(-1, -2))
    if kind == "euclidean":
        qn, gn = (qf * qf).sum(-1), (gf * gf).sum(-1)
        w = torch.sqrt(torch.clamp(qn[..., :, None] + gn[..., None, :]
                                   - 2.0 * dot, min=0.0)).reshape(s, d, t, k)
        ok = w <= thr
    else:
        qn, gn = torch.sqrt((qf * qf).sum(-1)), torch.sqrt((gf * gf).sum(-1))
        denom = qn[..., :, None] * gn[..., None, :]
        sim = (dot / torch.where(denom > 0, denom, 1.0)).reshape(s, d, t, k)
        ok, w = sim >= thr, 1.0 - sim
    valid = (use_gate[..., :, None, None] & compat[..., None]
             & track_gate[..., None, :, None] & feat_valid[..., None, :, :]
             & ok)
    votes = valid.sum(-1)
    max_dist = torch.where(valid, w, NEG).amax(dim=(-3, -2, -1))
    terms = torch.where(valid, max_dist[:, None, None, None] - w, 0.0)
    weight = torch.zeros_like(terms[..., 0])
    for lane in range(k):
        weight = weight + terms[..., lane]
    eligible = (votes >= min_votes) & det_valid[..., None]
    wm = torch.where(eligible, weight, NEG)
    _, t1 = asg.first_argmax(wm, -1)
    has_any = eligible.any(-1)
    _, best_query = asg.first_argmax(wm, -2)
    wins = has_any & (best_query.gather(-1, t1) == torch.arange(d))
    claimed = mrg.written(mrg.write_index(t1, wins, t), t)
    return t1, has_any, wins, claimed


def _assert_equal(got, want):
    for name, a, b in zip(("t1", "has_any", "wins", "claimed"), got, want):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def _check(shape, kind, precision, case, min_votes=1, seed=0):
    inputs = votes_inputs(seed, *shape, kind, case)
    args = votes_args(inputs, kind, precision, CPU)
    got = vv.visual_best_fit_plain(*args, min_votes)
    _assert_equal(got, _composition(inputs, kind, precision, min_votes))
    return got


@pytest.mark.parametrize("case", VOTE_CASES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
def test_plain_version_equals_the_step_composition(kind, precision, case):
    t1, has_any, wins, claimed = _check((3, 12, 20, 3, 16), kind, precision,
                                        case)
    if case in ("base", "broadcast", "nan"):
        assert wins.any() and claimed.any()
        # the exact copy of row 2 votes and loses to it
        assert has_any[:, 3].any() and not (wins[:, 2] & wins[:, 3]).any()
    if case == "empty":
        assert not has_any[0].any() and not claimed[0].any()
    if case == "no_pass":
        assert not has_any.any() and not claimed.any()


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, 4), (2, 5, 3, 1, 8), (1, 3, 33, 4, 8), (4, 37, 45, 2, 8),
    (1, 130, 7, 3, 8)])
@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
def test_plain_version_equals_the_step_composition_at_odd_shapes(kind,
                                                                 shape):
    _check(shape, kind, "f32", "base", seed=1)


@pytest.mark.parametrize("min_votes", [0, 2, 3])
def test_plain_version_equals_the_step_composition_at_min_votes(min_votes):
    t1, has_any, _, _ = _check((3, 12, 20, 3, 16), "euclidean", "f32",
                               "base", min_votes=min_votes, seed=2)
    if min_votes == 0:  # every valid row is eligible, voting or not
        assert has_any.sum() > 30


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """For CPU tensors `visual_best_fit` is the plain version, and launches
    (and counts) nothing."""
    args = votes_args(votes_inputs(3, 2, 9, 11, 3, 8, "cosine"), "cosine",
                      "f32", CPU)
    before = profiling.counter("visual_votes.launches")
    _assert_equal(vv.visual_best_fit(*args, 2),
                  vv.visual_best_fit_plain(*args, 2))
    assert profiling.counter("visual_votes.launches") == before


def test_wrapper_rejects_bad_inputs():
    args = list(votes_args(votes_inputs(5, 2, 4, 6, 3, 8, "euclidean"),
                           "euclidean", "f32", CPU))
    with pytest.raises(ValueError, match="kind"):
        vv.visual_best_fit(*args[:8], "manhattan", args[9], 1)
    with pytest.raises(TypeError, match="bool"):
        vv.visual_best_fit(*args[:4], args[4].int(), *args[5:], 1)
    with pytest.raises(TypeError, match="float32"):
        vv.visual_best_fit(args[0].double(), *args[1:], 1)
    with pytest.raises(ValueError, match="compat"):
        vv.visual_best_fit(*args[:4], args[4][:, :, :5], *args[5:], 1)
    with pytest.raises(ValueError, match="T=0"):
        vv.visual_best_fit(args[0][..., :0], args[1], args[2][:, :0],
                           args[3], args[4][..., :0], args[5][:, :0],
                           args[6][:, :0], *args[7:], 1)
    with pytest.raises(ValueError, match="D=0"):
        vv.visual_best_fit(args[0][:, :0], args[1][:, :0], args[2],
                           args[3][:, :0], args[4][:, :0], args[5],
                           args[6], args[7][:, :0], *args[8:], 1)
