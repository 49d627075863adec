"""The port's fused SORT chunk (plain PyTorch version, on the CPU) against
the JAX package's Pallas kernel in interpret mode.

Ids, slots, overflow flags and next_id must be equal: they decide track
identity.  Boxes and Kalman state are held at torch_parity.RTOL/ATOL, the
tolerance of the JAX package's own kernel tests (XLA may contract a
multiply-add that PyTorch rounds twice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops.pallas_sort import compiled_pallas_sort_scan, forward_auction
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu_torch.convert import sort_state_from_numpy, sort_state_to_numpy
from similari_tpu_torch.ops.assignment import MAX_AUCTION_ROUNDS
from similari_tpu_torch.ops import fused_sort
from similari_tpu_torch.ops.fused_sort import (allocate_slots,
                                               forward_auction_plain,
                                               fused_sort_chunk,
                                               fused_sort_chunk_plain,
                                               fused_sort_scan,
                                               state_to_tuple)
from similari_tpu_torch.trackers.sort_step import SortConfig

from kernel_replay import (bid_keys, cluster_auction_replay,
                           cluster_slots_replay)

from torch_parity import (ATOL, RTOL, assert_state_dicts_match,
                          crowded_stream, jax_state_dict,
                          one_cpu_thread, sort_overflow_stream,
                          sort_stream)

one_cpu_thread()

CPU = torch.device("cpu")
STEPS, D, T, CHUNK = 8, 8, 32, 4


def _run_both(cfg_kw, box, valid, t, conf=None):
    """Both packages from the same (empty JAX) state, crossing through the
    numpy dict.  Returns (jax state dict, jax outputs, port state dict,
    port outputs) as numpy."""
    conf = np.ones(valid.shape, np.float32) if conf is None else conf
    st = jax_new_sort_state(t, 1)
    start = jax_state_dict(st)
    run = compiled_pallas_sort_scan(JaxSortConfig(**cfg_kw), CHUNK,
                                    interpret=True)
    sj, outs_j = run(st, jnp.asarray(box), jnp.asarray(conf),
                     jnp.asarray(valid), jnp.int32(1))
    sp, outs_p = fused_sort_scan(
        SortConfig(**cfg_kw), sort_state_from_numpy(start, CPU),
        torch.tensor(box), torch.tensor(conf), torch.tensor(valid), 1, CHUNK)
    return (jax_state_dict(sj), [np.asarray(x) for x in outs_j],
            sort_state_to_numpy(sp), [x.numpy() for x in outs_p])


@pytest.fixture(scope="module")
def refs():
    """One JAX interpret run per stream, shared by the tests reading it."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


BASE = dict(method="iou", assignment="auction", max_idle_epochs=5,
            oriented=False)


def _stream_run(refs, seed):
    return refs(("stream", seed), lambda: _run_both(
        BASE, *sort_stream(seed, STEPS, D), T))


def _overflow_run(refs, recycle):
    cfg = dict(BASE, max_idle_epochs=2, recycle_idle=recycle)
    return refs(("overflow", recycle), lambda: _run_both(
        cfg, *sort_overflow_stream(STEPS, D), 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_sort_outputs_match_pallas(refs, seed):
    _, oj, _, op = _stream_run(refs, seed)
    ids, slots, pred, ovf = op
    # every row, padded ones included: the kernels compute them alike
    np.testing.assert_array_equal(ids, oj[0])
    np.testing.assert_array_equal(slots, oj[1])
    np.testing.assert_array_equal(ovf, oj[3])
    np.testing.assert_allclose(pred, oj[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_sort_state_matches_pallas(refs, seed):
    sj, _, sp, _ = _stream_run(refs, seed)
    assert_state_dicts_match(sj, sp)
    assert int(sp["next_id"]) >= int(sp["track_id"].max())


@pytest.mark.parametrize("recycle", [False, True])
def test_fused_sort_overflow_and_zero_padding(refs, recycle):
    """Capacity 8 < new tracks: the overflowing frame writes nothing while
    next_id advances; all-zero padded rows must not NaN the state."""
    sj, oj, sp, op = _overflow_run(refs, recycle)
    assert oj[3].any()  # the regime is exercised
    assert np.isfinite(sp["pred_box"]).all()
    np.testing.assert_array_equal(op[0], oj[0])
    np.testing.assert_array_equal(op[1], oj[1])
    np.testing.assert_array_equal(op[3], oj[3])
    assert_state_dicts_match(sj, sp)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_sort_crowded_auction_matches_pallas(refs, seed):
    """Overlapping objects and re-detections (one an exact copy, so equal
    bids meet): the auction runs several rounds per frame, evicting
    outbid owners, and both packages still agree on every id."""
    box, conf, valid = crowded_stream(seed, STEPS, 16, 12, 16, 133.0,
                                       copies=1)[:3]
    cfg = dict(BASE, recycle_idle=True)
    sj, oj, sp, op = refs(("crowded", seed), lambda: _run_both(
        cfg, box, valid, 64, conf))
    stats = fused_sort_chunk(
        SortConfig(**cfg), state_to_tuple(sort_state_from_numpy(
            jax_state_dict(jax_new_sort_state(64, 1)), CPU)),
        torch.tensor(box), torch.tensor(conf), torch.tensor(valid), 1)[5]
    assert stats[:, 0].float().mean() > 2  # the auction contends
    for i in (0, 1, 3):
        np.testing.assert_array_equal(op[i], oj[i])
    np.testing.assert_allclose(op[2], oj[2], rtol=RTOL, atol=ATOL)
    assert_state_dicts_match(sj, sp)


@pytest.mark.parametrize("case", ["random", "ties", "contested", "padded"])
def test_forward_auction_plain_matches_pallas(case):
    """The auction alone, on matrices chosen for tie order: integer weights
    (many equal bids and equal row maxima), many rows contending for one
    column, and padded rows."""
    rng = np.random.default_rng(["random", "ties", "contested",
                                 "padded"].index(case))
    d, t = 12, 20
    if case == "ties":
        W = rng.integers(0, 3, size=(d, t)).astype(np.float32) * 0.25
    elif case == "contested":
        W = np.zeros((d, t), np.float32)
        W[:, 0] = rng.uniform(0.5, 0.6, d)
        W[:, 1] = rng.uniform(0.4, 0.5, d)
    else:
        W = rng.uniform(0, 1, size=(d, t)).astype(np.float32)
        W[W < 0.6] = 0.0
    dvalid = np.ones(d, bool)
    if case == "padded":
        dvalid[d // 2:] = False
        W[~dvalid] = 0.0
    thr = 0.3
    A = np.concatenate(
        [np.where(np.eye(d, dtype=bool) & dvalid[:, None], thr, 0.0)
         .astype(np.float32), W], axis=1)
    r2c_j = np.asarray(jax.jit(forward_auction)(jnp.asarray(A),
                                                jnp.asarray(dvalid)))
    r2c_p, rounds, bids = forward_auction_plain(torch.tensor(A),
                                                torch.tensor(dvalid))
    np.testing.assert_array_equal(r2c_p.numpy(), r2c_j)
    assert 1 <= rounds <= 3000 and bids >= int(dvalid.sum())


def test_state_roundtrip_through_numpy(refs):
    """convert.py keeps every field of a JAX state (nonzero values)."""
    sj, _, _, _ = _stream_run(refs, 0)
    back = sort_state_to_numpy(sort_state_from_numpy(sj, CPU))
    assert_state_dicts_match(sj, back)
    for k in ("active", "track_id", "last_epoch"):
        np.testing.assert_array_equal(back[k], sj[k])


def test_chunk_outputs_and_stats():
    """The chunk entry point itself: shapes, dtypes, and one auction per
    frame counted in its statistics."""
    box, valid = sort_stream(0, CHUNK, D)
    cfg = SortConfig(**BASE)
    st = state_to_tuple(sort_state_from_numpy(
        jax_state_dict(jax_new_sort_state(T, 1)), CPU))
    conf = torch.ones(CHUNK, D)
    st2, ids, slots, pred, ovf, stats = fused_sort_chunk(
        cfg, st, torch.tensor(box), conf, torch.tensor(valid), 1)
    assert ids.shape == (CHUNK, D) and ids.dtype == torch.int32
    assert pred.shape == (CHUNK, D, 5) and ovf.dtype == torch.bool
    assert stats.shape == (CHUNK, 3) and (stats[:, 0] >= 1).all()
    assert int(st2[12][0]) == D  # frame 0 opens D tracks, later frames match
    assert int(st[12][0]) == 0  # the input state is not modified


def test_out_of_scope_configs_raise():
    box, valid = sort_stream(0, CHUNK, D)
    st = state_to_tuple(sort_state_from_numpy(
        jax_state_dict(jax_new_sort_state(T, 1)), CPU))
    for bad in (dict(BASE, method="maha"), dict(BASE, oriented=True),
                dict(BASE, constraints=((1, 1.0),))):
        with pytest.raises(NotImplementedError, match="sort_scan"):
            fused_sort_chunk(SortConfig(**bad), st, torch.tensor(box),
                             torch.ones(CHUNK, D), torch.tensor(valid), 1)
    deep = sort_state_from_numpy(jax_state_dict(jax_new_sort_state(T, 2)), CPU)
    with pytest.raises(NotImplementedError, match="history"):
        fused_sort_scan(SortConfig(**BASE), deep, torch.tensor(box),
                        torch.ones(CHUNK, D), torch.tensor(valid), 1, CHUNK)


def test_config_defaults_match_jax():
    """The port's SortConfig carries the reference's fields and defaults."""
    a = {f.name: f.default for f in dataclasses.fields(JaxSortConfig)}
    b = {f.name: f.default for f in dataclasses.fields(SortConfig)}
    assert a == b


def test_chunk_rejects_malformed_inputs():
    """The wrapper checks what it would hand to the kernel as raw
    pointers: dtypes, shapes and the state's layout."""
    box, valid = sort_stream(0, CHUNK, D)
    st = state_to_tuple(sort_state_from_numpy(
        jax_state_dict(jax_new_sort_state(T, 1)), CPU))
    cfg = SortConfig(**BASE)
    args = (torch.tensor(box), torch.ones(CHUNK, D), torch.tensor(valid))
    with pytest.raises(TypeError):
        fused_sort_chunk(cfg, st, args[0].double(), *args[1:], 1)
    with pytest.raises(ValueError, match="conf and valid"):
        fused_sort_chunk(cfg, st, args[0], torch.ones(CHUNK, D + 1),
                         args[2], 1)
    with pytest.raises(ValueError, match="entries"):
        fused_sort_chunk(cfg, st[:-1], *args, 1)
    with pytest.raises(ValueError, match="state entry"):
        fused_sort_chunk(cfg, (st[0].double(),) + st[1:], *args, 1)


# ---------------------------------------------------------------------------
# the CUDA kernel's split over a cluster of G blocks, replayed on the CPU
# ---------------------------------------------------------------------------

def _replay_stream(case):
    """(config, box, conf, valid, capacity T)."""
    if case.startswith("stream"):
        box, valid = sort_stream(int(case[-1]), STEPS, D)
        return BASE, box, np.ones(valid.shape, np.float32), valid, 200
    if case.startswith("overflow"):
        box, valid = sort_overflow_stream(STEPS, D)
        cfg = dict(BASE, max_idle_epochs=2,
                   recycle_idle=case.endswith("recycle"))
        return cfg, box, np.ones(valid.shape, np.float32), valid, 8
    if case == "padded":
        box, valid = sort_stream(4, STEPS, D)
        valid[2] = False
        valid[5] = False
        return BASE, box, np.ones(valid.shape, np.float32), valid, 64
    seed = int(case[-1])
    box, conf, valid = crowded_stream(seed, STEPS, 16, 12, 16, 133.0,
                                      copies=1)[:3]
    return dict(BASE, recycle_idle=True), box, conf, valid, (64, 500)[seed]


@pytest.mark.parametrize("case,g", [
    ("stream0", 8), ("stream1", 3), ("overflow", 3), ("overflow_recycle", 8),
    ("padded", 16), ("crowded0", 8), ("crowded1", 16)])
def test_cluster_replay_chunk_matches_plain(case, g, monkeypatch):
    """The whole chunk with the auction and the slot allocation split over
    g column blocks as the kernel splits them (T = 200, 500, 8 and 64: not
    multiples of g) gives the plain chunk's ids, slots, overflow flags,
    auction statistics and state exactly."""
    kw, box, conf, valid, t = _replay_stream(case)
    st = state_to_tuple(sort_state_from_numpy(
        jax_state_dict(jax_new_sort_state(t, 1)), CPU))
    args = [torch.tensor(x) for x in (box, conf, valid)]
    cfg = SortConfig(**kw)
    plain = fused_sort_chunk_plain(cfg, st, *args, 1)
    monkeypatch.setattr(fused_sort, "forward_auction_plain",
                        lambda A, dvalid: cluster_auction_replay(A, dvalid, g))
    monkeypatch.setattr(fused_sort, "allocate_slots",
                        lambda *xs: cluster_slots_replay(*xs, g))
    replay = fused_sort_chunk_plain(cfg, st, *args, 1)
    for a, b in zip(plain[1:], replay[1:]):
        assert torch.equal(a, b)
    for a, b in zip(plain[0], replay[0]):
        assert torch.equal(a, b)
    if case.startswith("crowded"):
        assert plain[5][:, 0].float().mean() > 2


def _auction_matrix(case):
    """(A [D, D+T], dvalid) for the auction on its own."""
    rng = np.random.default_rng(len(case))
    d, t, thr = 12, 200, 0.3
    if case == "ties":  # integer weights: equal values and equal bids
        W = rng.integers(0, 3, size=(d, t)).astype(np.float32) * 0.25
    elif case == "equal_rows":  # exact copies bid equal amounts
        W = np.repeat(rng.uniform(0, 1, size=(d // 3, t)), 3, axis=0)
        W = W.astype(np.float32)
    elif case == "contested":
        W = np.zeros((d, t), np.float32)
        W[:, 7] = rng.uniform(0.5, 0.6, d)
        W[:, 150] = rng.uniform(0.4, 0.5, d)
    elif case == "d1":
        d, t = 1, 500
        W = rng.uniform(0, 1, size=(d, t)).astype(np.float32)
    elif case == "cap":  # three rows, two equal columns: a price war
        d, t, thr = 3, 500, 0.0
        W = np.zeros((d, t), np.float32)
        W[:, 3:5] = 1.0
    else:
        W = rng.uniform(0, 1, size=(d, t)).astype(np.float32)
        W[W < 0.6] = 0.0
    dvalid = np.ones(d, bool)
    if case == "padded":
        dvalid[d // 2:] = False
        W[~dvalid] = 0.0
    A = np.concatenate([np.where(np.eye(d, dtype=bool) & dvalid[:, None],
                                 thr, 0.0).astype(np.float32), W], axis=1)
    return torch.tensor(A), torch.tensor(dvalid)


@pytest.mark.parametrize("g", [2, 8, 16])
@pytest.mark.parametrize("case", ["random", "ties", "equal_rows",
                                  "contested", "padded", "d1", "cap"])
def test_cluster_auction_replay_matches_plain(case, g):
    """Per-block partials merged in block order and the (bid, lowest row)
    key per column give `forward_auction_plain`'s columns, rounds and bids
    on ties, exact copies, one contested column, padded rows, D = 1 and a
    price war cut at 3000 rounds."""
    A, dvalid = _auction_matrix(case)
    r2c, rounds, bids = forward_auction_plain(A, dvalid)
    r2c_g, rounds_g, bids_g = cluster_auction_replay(A, dvalid, g)
    assert torch.equal(r2c, r2c_g)
    assert (rounds, bids) == (rounds_g, bids_g)
    if case == "cap":
        assert rounds == MAX_AUCTION_ROUNDS


def test_bid_keys_order_bids_then_rows():
    """The packed key orders by bid, then by the lower row, for positive
    bids (the auction's), equal bids and neighbouring floats."""
    bid = torch.tensor([0.5, 0.5, np.nextafter(np.float32(0.5), 1),
                        1e-7, 3.0e4], dtype=torch.float32)
    rows = torch.tensor([4, 2, 9, 0, 1023])
    order = torch.argsort(bid_keys(bid, rows), descending=True)
    assert order.tolist() == [4, 2, 1, 0, 3]


@pytest.mark.parametrize("t,g", [(200, 8), (500, 16), (500, 3), (7, 8)])
def test_cluster_slots_replay_matches_allocate_slots(t, g):
    """Free-slot ranks as an exclusive scan of the blocks' free counts plus
    each block's own list: the r-th new row takes the r-th free slot in
    slot order across blocks, with and without overflow."""
    rng = np.random.default_rng(t + g)
    for frac, d in ((0.3, 40), (0.02, 40), (0.9, 3)):
        free = torch.tensor(rng.uniform(size=t) < frac)
        is_new = torch.tensor(rng.uniform(size=d) < 0.5)
        matched = ~is_new & torch.tensor(rng.uniform(size=d) < 0.5)
        tgt = torch.tensor(rng.integers(0, t, d))
        want = allocate_slots(is_new, matched, tgt, free)
        got = cluster_slots_replay(is_new, matched, tgt, free, g)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
