"""The port's general SORT step, its assignment, merges and constraints
against the JAX package, on the CPU.

Ids, slots, is_new, lengths, overflow flags and next_id must be equal;
boxes and Kalman state are held at torch_parity.RTOL/ATOL (XLA may
contract a multiply-add that PyTorch rounds twice).  The sorted
(clip-kernel) path is compared with the JAX sorted path, whose Pallas
kernel runs in interpret mode: the sorted and the dense matcher solve the
same LP but may resolve near-ties differently.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.eval import mot as jmot
from similari_tpu.ops import assignment as jasg
from similari_tpu.ops import merge as jmrg
from similari_tpu.trackers.constraints import (
    SpatioTemporalConstraints as JaxConstraints,
    allowed_distance_for_delta as jax_allowed)
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.sort_step import compiled_sort_scan
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu_torch.convert import sort_state_from_numpy, sort_state_to_numpy
from similari_tpu_torch.eval import mot as pmot
from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.ops import kalman as kal
from similari_tpu_torch.ops import merge as mrg
from similari_tpu_torch.trackers.constraints import (
    SpatioTemporalConstraints, allowed_distance_for_delta)
from similari_tpu_torch.trackers.sort_step import (SortConfig, StepOutput,
                                                   sort_scan, sort_step,
                                                   use_sorted_path)
from similari_tpu_torch.trackers.state import new_sort_state

from torch_parity import (ATOL, RTOL, assert_state_dicts_match,
                          crowded_stream, jax_state_dict, one_cpu_thread,
                          oriented_stream, sort_overflow_stream)

one_cpu_thread()

CPU = torch.device("cpu")
OUTPUTS = ("slot", "track_id", "is_new", "length", "overflow")


# --------------------------------------------------------------------------
# assignment
# --------------------------------------------------------------------------

def _tracking_matrix(rng, d, t):
    """IoU-like weights: each row near one track, a few rivals, mostly 0."""
    w = np.zeros((d, t), np.float32)
    for r in range(d):
        cols = rng.choice(t, size=3, replace=False)
        w[r, cols] = rng.uniform(0.3, 1.0, 3)
    return w


def _matrices():
    rng = np.random.default_rng(0)
    out = {
        "random": rng.uniform(0, 1, (12, 20)).astype(np.float32),
        "tracking": _tracking_matrix(rng, 16, 40),
        "ties": rng.integers(0, 3, (10, 14)).astype(np.float32) / 2,
        "contested": np.tile(rng.uniform(0.5, 1, (1, 6)), (9, 1)).astype(
            np.float32),
    }
    out["sparse_rows"] = out["tracking"].copy()
    out["sparse_rows"][::3] = 0.0
    return out


MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_auction_lap_fallback_matches_jax(name):
    w = MATRICES[name]
    for theta in (0.3, 0.6):
        j = np.asarray(jasg.auction_lap_fallback(jnp.asarray(w), theta))
        p = asg.auction_lap_fallback(torch.tensor(w), theta).numpy()
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_auction_lap_matches_jax(name):
    w = MATRICES[name]
    a = jasg.augment_with_threshold(jnp.asarray(w), 0.4,
                                    jnp.ones(w.shape[0], bool),
                                    jnp.ones(w.shape[1], bool))
    j = np.asarray(jasg.auction_lap(a))
    p = asg.auction_lap(torch.tensor(np.asarray(a))).numpy()
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("backend", ["auction", "hungarian"])
@pytest.mark.parametrize("name", ["tracking", "sparse_rows", "random"])
def test_solve_voting_matches_jax(backend, name):
    w = MATRICES[name]
    rng = np.random.default_rng(1)
    rv = rng.uniform(size=w.shape[0]) < 0.8
    cv = rng.uniform(size=w.shape[1]) < 0.8
    j = np.asarray(jasg.solve_voting(jnp.asarray(w), 0.5, jnp.asarray(rv),
                                     jnp.asarray(cv), backend))
    p = asg.solve_voting(torch.tensor(w), 0.5, torch.tensor(rv),
                         torch.tensor(cv), backend).numpy()
    np.testing.assert_array_equal(p, j)
    aj = np.asarray(jasg.augment_with_threshold(
        jnp.asarray(w), 0.5, jnp.asarray(rv), jnp.asarray(cv)))
    ap = asg.augment_with_threshold(torch.tensor(w), 0.5, torch.tensor(rv),
                                    torch.tensor(cv)).numpy()
    np.testing.assert_array_equal(ap, aj)


def test_auction_round_cap_keeps_a_matching():
    """Capped at 1 round, some rows stay unassigned; the fix-up gives them
    free columns in order, as the JAX package does."""
    w = MATRICES["contested"]
    j = np.asarray(jasg.auction_lap(jnp.asarray(w.T.copy()), max_iters=1))
    p = asg.auction_lap(torch.tensor(w.T.copy()), max_iters=1).numpy()
    np.testing.assert_array_equal(p, j)
    assert len(set(p.tolist())) == len(p)


def test_resolve_backend():
    assert asg.resolve_backend("auto", torch.device("cuda")) == "auction"
    assert asg.resolve_backend("auto", CPU) == "hungarian"
    assert asg.resolve_backend("hungarian", torch.device("cuda")) == "hungarian"
    w = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 1.0]])
    np.testing.assert_array_equal(asg.solve_lap(w, "native").numpy(), [1, 0])
    np.testing.assert_array_equal(asg.solve_lap(w, "native").numpy(),
                                  asg.solve_lap(w, "hungarian").numpy())
    with pytest.raises(ValueError):
        asg.solve_lap(torch.zeros(2, 4), "bogus")


# --------------------------------------------------------------------------
# merges and constraints
# --------------------------------------------------------------------------

def test_merge_semantics_match_jax():
    rng = np.random.default_rng(2)
    t, d, h = 12, 6, 3
    active = rng.uniform(size=t) < 0.5
    slot = rng.permutation(t)[:d].astype(np.int32)
    safe = np.array([1, 1, 0, 1, 0, 1], bool)
    src = rng.normal(size=(d, 5)).astype(np.float32)
    src[~safe] = np.nan  # unwritten rows never reach the state
    old = rng.normal(size=(t, 5)).astype(np.float32)
    ring_old = rng.normal(size=(t, h, 5)).astype(np.float32)
    ring_ix = rng.integers(0, h, d).astype(np.int32)
    hit = jmrg.writer_hit(jnp.asarray(slot), jnp.asarray(safe), t)
    np.testing.assert_array_equal(
        mrg.writer_hit(torch.tensor(slot), torch.tensor(safe), t).numpy(),
        np.asarray(hit))
    index = mrg.write_index(torch.tensor(slot), torch.tensor(safe), t)
    np.testing.assert_array_equal(mrg.written(index, t).numpy(),
                                  np.asarray(hit).any(1))
    rows = mrg.merge_rows(torch.tensor(old), torch.tensor(src), index).numpy()
    np.testing.assert_array_equal(
        rows, np.asarray(jmrg.merge_rows(jnp.asarray(old), jnp.asarray(src),
                                         hit)))
    ring = mrg.merge_ring(torch.tensor(ring_old), torch.tensor(src),
                          torch.tensor(ring_ix), index).numpy()
    np.testing.assert_array_equal(ring, np.asarray(jmrg.merge_ring(
        jnp.asarray(ring_old), jnp.asarray(src), jnp.asarray(ring_ix), hit)))
    assert np.isfinite(rows).all() and np.isfinite(ring).all()
    want = np.arange(-2, t + 2, dtype=np.int32)
    np.testing.assert_array_equal(
        mrg.nth_free_slot(torch.tensor(active), torch.tensor(want)).numpy(),
        np.asarray(jmrg.nth_free_slot(jnp.asarray(active),
                                      jnp.asarray(want))))
    np.testing.assert_array_equal(
        mrg.take_rows(torch.tensor(old), torch.tensor(slot)).numpy(),
        np.asarray(jmrg.take_rows(jnp.asarray(old), jnp.asarray(slot))))
    cols = slot % 5
    np.testing.assert_array_equal(
        mrg.take_at(torch.tensor(src), torch.tensor(cols)).numpy(),
        np.asarray(jmrg.take_at(jnp.asarray(src), jnp.asarray(cols))))


def test_constraints_match_jax():
    spec = [(5, 3.0), (1, 1.0), (5, 9.0), (10, 4.0)]
    p = SpatioTemporalConstraints().constraints(spec)
    j = JaxConstraints().constraints(spec)
    assert p.as_tuple() == j.as_tuple() == ((1, 1.0), (5, 3.0), (10, 4.0))
    for delta in range(0, 13):
        for dist in (0.5, 2.0, 3.5, 5.0):
            assert p.validate(delta, dist) == j.validate(delta, dist)
    delta = np.arange(-1, 14, dtype=np.int32)
    np.testing.assert_array_equal(
        allowed_distance_for_delta(p.as_tuple(), torch.tensor(delta)).numpy(),
        np.asarray(jax_allowed(p.as_tuple(), jnp.asarray(delta))))
    with pytest.raises(ValueError):
        SpatioTemporalConstraints().add_constraints([(1, 0.0)])


# --------------------------------------------------------------------------
# the step and the scan
# --------------------------------------------------------------------------

BASE = dict(method="iou", assignment="auction", max_idle_epochs=5)
GAPS = np.array([1, 2, 3, 7, 8, 9, 20, 21], np.int32)


def _stream(kind):
    """(box, conf, valid, epochs, T) per stream kind, 8 frames."""
    ep = np.arange(1, 9, dtype=np.int32)
    if kind == "aligned":
        return (*oriented_stream(0, 8, 8, oriented=False), ep, 32)
    if kind == "oriented":
        return (*oriented_stream(1, 8, 8), ep, 32)
    if kind == "gaps":
        return (*oriented_stream(2, 8, 8, oriented=False), GAPS, 32)
    if kind == "crowded":
        return (*crowded_stream(0, 8, 16, 12, 16, 133.0, copies=1)[:3], ep,
                64)
    if kind == "overflow":
        box, valid = sort_overflow_stream(8, 8)
        return box, np.ones(valid.shape, np.float32), valid, ep, 12
    if kind == "sorted":  # clears the sorted path's gate: d=64, t=512
        box, conf, valid = oriented_stream(3, 6, 64, spread=2500.0)
        return box, conf, valid, ep[:6], 512
    raise KeyError(kind)


CASES = {
    "aligned_iou": (dict(BASE, oriented=False), "aligned", 1),
    "aligned_hungarian": (dict(BASE, oriented=False, assignment="hungarian"),
                          "aligned", 1),
    "oriented_dense": (dict(BASE, oriented=True, oriented_block_sort=False),
                       "oriented", 1),
    "oriented_sorted": (dict(BASE, oriented=True, oriented_block_sort=True),
                        "sorted", 1),
    "oriented_sorted_hungarian": (dict(BASE, oriented=True,
                                       oriented_block_sort=True,
                                       assignment="hungarian"), "sorted", 1),
    "maha": (dict(BASE, method="maha", oriented=False), "aligned", 1),
    "maha_oriented_hungarian": (dict(BASE, method="maha",
                                     assignment="hungarian"), "oriented", 1),
    "constraints": (dict(BASE, oriented=False,
                         constraints=((1, 0.5), (5, 1.5))), "gaps", 1),
    "history3": (dict(BASE, oriented=True), "oriented", 3),
    "recycle_idle": (dict(BASE, oriented=False, recycle_idle=True,
                          max_idle_epochs=2), "gaps", 1),
    "overflow": (dict(BASE, oriented=False, max_idle_epochs=2), "overflow",
                 1),
    "overflow_recycle": (dict(BASE, oriented=False, max_idle_epochs=2,
                              recycle_idle=True), "overflow", 1),
    "crowded_auction": (dict(BASE, oriented=False, recycle_idle=True),
                        "crowded", 1),
    "crowded_maha": (dict(BASE, method="maha", oriented=False), "crowded",
                     1),
}


def _run_both(case):
    kw, kind, h = CASES[case]
    box, conf, valid, epochs, t = _stream(kind)
    st = jax_new_sort_state(t, h)
    start = jax_state_dict(st)
    sj, oj = compiled_sort_scan(JaxSortConfig(**kw))(
        st, jnp.asarray(box), jnp.asarray(conf), jnp.asarray(valid),
        jnp.asarray(epochs))
    sp, op = sort_scan(SortConfig(**kw), sort_state_from_numpy(start, CPU),
                       torch.tensor(box), torch.tensor(conf),
                       torch.tensor(valid), epochs)
    return valid, (jax_state_dict(sj), oj), (sort_state_to_numpy(sp), op)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_scan_matches_jax(case):
    valid, (sj, oj), (sp, op) = _run_both(case)
    for name in OUTPUTS:
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(op.pred_box.numpy()[valid],
                               np.asarray(oj.pred_box)[valid],
                               rtol=RTOL, atol=ATOL)
    assert_state_dicts_match(sj, sp)
    assert np.isfinite(sp["pred_box"]).all()
    if case.startswith("overflow"):
        assert op.overflow.any()  # the regime is exercised
    if case.startswith("crowded"):
        assert (~op.is_new.numpy() & valid).sum() > valid.sum() // 2


def test_sorted_path_tracks_like_dense_path():
    """The sorted and the dense matcher solve the same LP: on a scene
    without near-ties they give the same ids."""
    box, conf, valid, epochs, t = _stream("sorted")
    outs = []
    for block in (True, False):
        cfg = SortConfig(**dict(BASE, oriented=True,
                                oriented_block_sort=block))
        _, o = sort_scan(cfg, new_sort_state(t, 1, device=CPU),
                         torch.tensor(box), torch.tensor(conf),
                         torch.tensor(valid), epochs)
        outs.append(o)
    for name in OUTPUTS:
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name))


def test_sorted_path_gate():
    cfg = SortConfig(**dict(BASE, oriented=True))
    cuda = torch.device("cuda")
    assert use_sorted_path(cfg, 64, 512, cuda)
    assert not use_sorted_path(cfg, 64, 512, CPU)
    assert not use_sorted_path(cfg, 63, 512, cuda)
    assert not use_sorted_path(cfg, 64, 511, cuda)
    assert use_sorted_path(dataclasses.replace(cfg, oriented_block_sort=True),
                           64, 512, CPU)
    assert not use_sorted_path(
        dataclasses.replace(cfg, oriented_block_sort=False), 64, 512, cuda)
    assert not use_sorted_path(dataclasses.replace(cfg, method="maha"),
                               64, 512, cuda)
    assert not use_sorted_path(dataclasses.replace(cfg, oriented=False),
                               64, 512, cuda)


def test_sort_step_single_frame():
    box, conf, valid, _, t = _stream("aligned")
    cfg = SortConfig(**dict(BASE, oriented=False))
    st = new_sort_state(t, 1, device=CPU)
    st2, out = sort_step(cfg, st, torch.tensor(box[0]), torch.tensor(conf[0]),
                         torch.tensor(valid[0]), 1)
    assert isinstance(out, StepOutput)
    n = int(valid[0].sum())
    assert int(st2.next_id) == n and int(st2.active.sum()) == n
    assert int(st.next_id) == 0 and not st.active.any()  # input unchanged
    assert out.is_new.sum() == n and out.track_id.dtype == torch.int32


def test_empty_state_needs_a_device(monkeypatch):
    """`device=None` means CUDA everywhere in the port, the Kalman state
    included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kal.empty_state(4)
    assert kal.empty_state(4, device="cpu").mean_pos.device == CPU


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------

def _detections(seed, frames=(1, 2, 3, 4, 6, 7, 9, 10, 11, 14)):
    rng = np.random.default_rng(seed)
    n = 9
    xy = rng.uniform(0, 300, (n, 2))
    dets = {}
    for f in frames:
        xy += rng.uniform(-3, 3, xy.shape)
        keep = rng.uniform(size=n) < 0.9
        dets[f] = [(float(x) - 12, float(y) - 20, 24.0, 40.0,
                    float(rng.uniform(0.5, 1)))
                   for (x, y), k in zip(xy, keep) if k]
    return dets


@pytest.mark.parametrize("method,assignment", [("maha", "auction"),
                                               ("iou", "hungarian")])
def test_runner_step_engine_matches_jax(method, assignment):
    dets = _detections(0)
    out_j, _ = jmot.run_sequence_device(dets, method=method, engine="xla",
                                        assignment=assignment, capacity=16)
    out_p, fps = pmot.run_sequence_device(dets, method=method, engine="step",
                                          assignment=assignment, capacity=16,
                                          device="cpu")
    assert out_p.keys() == out_j.keys() and fps > 0
    for f in out_j:
        ids_j = [r[0] for r in out_j[f]]
        ids_p = [r[0] for r in out_p[f]]
        assert ids_p == ids_j, f
        np.testing.assert_allclose(np.array([r[1:] for r in out_p[f]]),
                                   np.array([r[1:] for r in out_j[f]]),
                                   rtol=RTOL, atol=1e-3)


def test_runner_rejects_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        pmot.run_sequence_device(_detections(0), engine="xla", device="cpu")
