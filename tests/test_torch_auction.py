"""The fallback auction (`ops/assignment.py`) on the CPU: the plain rounds
against the CUDA kernel's replay (`kernel_replay.auction_fb_replay`), the
properties the kernel's per-scene stop and its rounds counter rest on, the
routing of CPU tensors to the plain rounds, and the device counters of
`utils/profiling.py`.  The kernel itself runs in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.utils import profiling

from kernel_replay import auction_fb_replay
from torch_parity import (AUCTION_CASES, RAW_CASES, RAW_ROUNDS,
                          auction_inputs, one_cpu_thread)

one_cpu_thread()

MAX_ITERS = (1, 2, 3, asg.MAX_AUCTION_ROUNDS)
# (lanes a row, 16-byte loads): the kernel's three lane counts, both loads
SPLITS = ((8, False), (16, True), (32, False))


def _plain(w, rv, cv, theta, max_iters):
    """The plain rounds as the step calls them: `solve_voting`'s masked
    weights, or the raw weights."""
    tw = torch.tensor(w)
    if rv is not None:
        tw = asg.edges(tw, torch.tensor(rv), torch.tensor(cv))
    return asg.auction_lap_fallback_plain(tw, theta, max_iters)


def _rounds_until_settled(w, theta, max_iters):
    """Rounds of `_fb_round` until no row of the scene [D, T] is pending,
    at most max(UNROLLED_ROUNDS, max_iters), from the plain rounds'
    start."""
    w = w[None]
    eps = asg._eps(w, torch.clamp(w.amax(dim=(-2, -1)), min=theta))
    s, d, t = w.shape
    carry = (torch.zeros((s, t)), torch.full((s, d), -1),
             torch.full((s, t), -1))
    cap, n = max(asg.UNROLLED_ROUNDS, max_iters), 0
    while n < cap and bool((carry[1] == -1).any()):
        carry = asg._fb_round(carry, w, theta, eps)
        n += 1
    return n


@pytest.mark.parametrize("split", SPLITS, ids=lambda x: f"L{x[0]}{x[1]}")
@pytest.mark.parametrize("max_iters", MAX_ITERS)
@pytest.mark.parametrize("case", sorted(AUCTION_CASES))
def test_kernel_replay_matches_the_plain_rounds(case, max_iters, split):
    """The kernel's way (each scene to its own convergence over a list of
    pending rows, a row's top two merged from L lanes, per-column keys
    cleared by the winners, eps by the rounded reciprocal) gives the
    plain rounds' columns and `auction.rounds` on every case."""
    w, rv, cv, theta = auction_inputs(3, case)
    if case in RAW_CASES:
        max_iters = min(max_iters, RAW_ROUNDS)
    lanes, vec = split
    before = profiling.counter("auction.rounds")
    want = _plain(w, rv, cv, theta, max_iters).numpy()
    rounds = profiling.counter("auction.rounds") - before
    with np.errstate(invalid="ignore"):
        got, _, call = auction_fb_replay(w, theta, max_iters, rv, cv, lanes,
                                         vec and w.shape[2] % 4 == 0)
    np.testing.assert_array_equal(got, want)
    assert call == rounds


@pytest.mark.parametrize("max_iters", MAX_ITERS)
def test_a_batch_equals_each_scene_alone(max_iters):
    """The property the kernel's per-scene stop rests on: the plain rounds
    on a batch of one contested scene among easy ones give each scene's
    columns as the scene solved alone, whatever the cap (a round changes
    nothing in a scene with no pending row)."""
    w, rv, cv, theta = auction_inputs(5, "contested")
    tw = asg.edges(torch.tensor(w), torch.tensor(rv), torch.tensor(cv))
    assert _rounds_until_settled(tw[0], theta, asg.MAX_AUCTION_ROUNDS) > 3
    batch = asg.auction_lap_fallback_plain(tw, theta, max_iters)
    for i in range(tw.shape[0]):
        alone = asg.auction_lap_fallback_plain(tw[i], theta, max_iters)
        assert torch.equal(batch[i], alone), i


@pytest.mark.parametrize("max_iters", MAX_ITERS)
@pytest.mark.parametrize("case", ["tracking", "contested", "row_ties",
                                  "below_theta"])
def test_rounds_counted_a_call(case, max_iters):
    """`auction.rounds` a call is max(UNROLLED_ROUNDS, the rounds until no
    row of the batch's last scene is pending), capped at max_iters."""
    w, rv, cv, theta = auction_inputs(7, case)
    tw = asg.edges(torch.tensor(w), torch.tensor(rv), torch.tensor(cv))
    want = max([asg.UNROLLED_ROUNDS] + [
        _rounds_until_settled(x, theta, max_iters) for x in tw])
    before = profiling.counter("auction.rounds")
    asg.auction_lap_fallback_plain(tw, theta, max_iters)
    assert profiling.counter("auction.rounds") - before == want


def test_cpu_tensors_take_the_plain_rounds(monkeypatch):
    """A CPU tensor never reaches the kernel's wrapper and launches
    nothing: `auction_lap_fallback` and `solve_voting` give the plain
    rounds' columns, with their host checks."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper called on the CPU")

    monkeypatch.setattr(asg, "auction_fb_cuda", refuse)
    w, rv, cv, theta = auction_inputs(9, "contested")
    tw, trv, tcv = torch.tensor(w), torch.tensor(rv), torch.tensor(cv)
    launches = profiling.counter("auction.launches")
    checks = profiling.summary()["waits"].get(
        "auction.converged", {}).get("syncs", 0)
    masked = asg.edges(tw, trv, tcv)
    assert torch.equal(asg.solve_voting(tw, theta, trv, tcv, "auction"),
                       asg.auction_lap_fallback_plain(masked, theta))
    assert torch.equal(asg.auction_lap_fallback(masked[1], theta),
                       asg.auction_lap_fallback_plain(masked[1], theta))
    assert profiling.counter("auction.launches") == launches
    assert profiling.summary()["waits"]["auction.converged"]["syncs"] > checks


@pytest.mark.parametrize("kw,err", [
    (dict(weights=torch.zeros(2, 3, 4, dtype=torch.float64)), TypeError),
    (dict(), ValueError),  # CPU weights
])
def test_kernel_wrapper_refuses_bad_inputs_before_any_launch(kw, err):
    """The wrapper checks dtype and device before it touches a card (the
    card tests check masks and shapes)."""
    args = dict(dict(weights=torch.zeros(2, 3, 4), theta=0.3), **kw)
    with pytest.raises(err):
        asg.auction_fb_cuda(**args)


def test_device_counters_fold_into_the_counts():
    """A device counter's first element lands in `counter()` and
    `summary()["counts"]`, beside the host count of the same name;
    `reset()` drops it."""
    cpu = torch.device("cpu")
    profiling.reset()
    t = profiling.device_counter("test.rounds", cpu, 3)
    assert t.shape == (3,) and int(t.sum()) == 0
    assert profiling.device_counter("test.rounds", cpu, 3) is t
    t[0] += 7
    t[1] += 100  # a kernel's own slot: not counted
    profiling.count("test.rounds", 2)
    assert profiling.counter("test.rounds") == 9
    assert profiling.summary()["counts"]["test.rounds"] == 9
    profiling.reset()
    assert profiling.counter("test.rounds") == 0
    assert "test.rounds" not in profiling.summary()["counts"]
