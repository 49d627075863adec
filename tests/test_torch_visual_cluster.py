"""The fused VisualSORT kernel's split of a frame over its thread-block
cluster, replayed on the CPU (`kernel_replay.py`) and held to the plain
chunk (`ops/fused_visual.py::fused_visual_chunk_plain`) bit for bit.

The kernel deals the slots to G blocks in turn (slot t to block t % G).
The replays take the max gallery distance and the auction's span from the
blocks' partials, merge each row's first max over the blocks' columns and
test its win against the owner block's heaviest row, run the auction over
the dealt columns, and rank the free slots from the blocks' bit masks.
Patched into the plain chunk, they must give its ids, slots, voting types,
new flags, lengths, overflow flags, auction statistics and state exactly,
at slot counts that are not multiples of G.
"""

import numpy as np
import pytest
import torch

from similari_tpu_torch.ops import fused_visual, visual_votes
from similari_tpu_torch.ops.fused_visual import (VISUAL_CLUSTER,
                                                 fused_visual_chunk_plain,
                                                 state_to_tuple)

assert VISUAL_CLUSTER in (8, 16)
from similari_tpu_torch.ops.fused_sort import allocate_slots
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import VisualConfig

from kernel_replay import (visual_best_fit_replay, visual_max_distance_replay,
                           cluster_auction_replay, visual_slots_replay)
from torch_parity import (VISUAL_CONFIGS, crowded_stream, one_cpu_thread,
                          visual_overflow_stream, visual_padded_stream,
                          visual_stream)

one_cpu_thread()

CPU = torch.device("cpu")
GS = [8, 16]  # the cluster sizes measured on the card


def _stream(case):
    """(config, stream of 7 arrays)."""
    if case == "parity":
        return VISUAL_CONFIGS["euclid_iou"], visual_stream(0, 8, 8, 16)
    if case == "overflow":  # 64 fresh objects a frame: past T=500 by frame 8
        return (dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=10,
                     recycle_idle=True), visual_overflow_stream(8, 64, 16))
    if case == "padded":
        return (dict(VISUAL_CONFIGS["cosine_gates"], feature_precision="bf16"),
                visual_padded_stream(8, 16, 16))
    return (dict(VISUAL_CONFIGS["maha"], recycle_idle=True),
            crowded_stream(0, 8, 16, 12, 16, 133.0, noise=2.0, copies=1))


def _patch(monkeypatch, g):
    monkeypatch.setattr(fused_visual, "_max_distance",
                        lambda dists, valids: visual_max_distance_replay(
                            dists, valids, g))
    monkeypatch.setattr(visual_votes, "claim",
                        lambda w_m, eligible: visual_best_fit_replay(
                            w_m, eligible, g))
    monkeypatch.setattr(fused_visual, "forward_auction_plain",
                        lambda A, dvalid: cluster_auction_replay(
                            A, dvalid, g, dealt=True))
    monkeypatch.setattr(fused_visual, "allocate_slots",
                        lambda *xs: visual_slots_replay(*xs, g))


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("t", [7, 200, 500])
@pytest.mark.parametrize("case", ["parity", "overflow", "padded", "crowded"])
def test_visual_cluster_replay_chunk_matches_plain(case, t, g, monkeypatch):
    kw, stream = _stream(case)
    cfg = VisualConfig(**kw)
    st = state_to_tuple(new_visual_state(t, 1, 3, stream[3].shape[2],
                                         device=CPU))
    args = [torch.tensor(x) for x in stream]
    chunks = [(slice(0, 4), 1), (slice(4, 8), 5)]

    def run():
        state, outs = st, []
        for sl, epoch0 in chunks:
            state, *o = fused_visual_chunk_plain(
                cfg, state, *(x[sl] for x in args), epoch0)
            outs.append(o)
        return state, [torch.cat(x) for x in zip(*outs)]

    plain = run()
    _patch(monkeypatch, g)
    replay = run()
    for a, b in zip(plain[1], replay[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[0], replay[0]):
        assert torch.equal(a, b)
    if case == "crowded" and t >= 200:
        assert plain[1][7][:, 0].float().mean() > 2  # the auction contends
    if case == "overflow":
        assert bool(plain[1][6].any())


def _best_fit_weights(case, d, t, rng):
    """(w_m [D, T] with NEG where not eligible, eligible)."""
    if case == "ties":  # integer weights: equal maxima in rows and columns
        w = rng.integers(0, 3, size=(d, t)).astype(np.float32)
    elif case == "copies":  # exact copies of rows
        w = np.repeat(rng.uniform(0, 5, size=(d // 2, t)), 2, axis=0)
    else:
        w = rng.uniform(0, 5, size=(d, t))
    eligible = rng.uniform(size=(d, t)) < (0.02 if case == "sparse" else 0.5)
    w = np.where(eligible, w, -1e30).astype(np.float32)
    return torch.tensor(w), torch.tensor(eligible)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("t", [7, 200, 500])
@pytest.mark.parametrize("case", ["random", "ties", "copies", "sparse"])
def test_visual_best_fit_replay_matches_plain(case, t, g):
    """Each row's best track from the blocks' (first max, column) partials
    (ties to the lower column), each column's heaviest row from groups of
    rows (ties to the lower row), and the wins test across blocks give
    `ops/visual_votes.py::claim` exactly."""
    rng = np.random.default_rng(t + g)
    w_m, eligible = _best_fit_weights(case, 40, t, rng)
    want = visual_votes.claim(w_m, eligible)
    got = visual_best_fit_replay(w_m, eligible, g)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("t", [7, 200, 500])
def test_visual_slots_replay_matches_allocate_slots(t, g):
    """Free slots ranked from the blocks' bit masks of dealt slots: the
    r-th new row takes the r-th free slot in slot order, with and without
    overflow."""
    rng = np.random.default_rng(t * g)
    for frac, d in ((0.3, 40), (0.02, 40), (0.9, 3), (1.0, 64)):
        free = torch.tensor(rng.uniform(size=t) < frac)
        is_new = torch.tensor(rng.uniform(size=d) < 0.5)
        matched = ~is_new & torch.tensor(rng.uniform(size=d) < 0.5)
        tgt = torch.tensor(rng.integers(0, t, d))
        want = allocate_slots(is_new, matched, tgt, free)
        got = visual_slots_replay(is_new, matched, tgt, free, g)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("t", [7, 200, 500])
def test_visual_max_distance_replay_matches_plain(t, g):
    """The largest passing distance from the blocks' partials, with the
    largest placed in each block's lanes in turn (and nowhere passing)."""
    rng = np.random.default_rng(t + 7 * g)
    d, k = 12, 3
    for hot in list(range(min(g, t))) + [None]:
        dists, valids = [], []
        for i in range(k):
            w = torch.tensor(rng.uniform(0, 1, (d, t)), dtype=torch.float32)
            v = torch.tensor(rng.uniform(size=(d, t)) < 0.3)
            if hot is None:
                v[:] = False
            elif i == k - 1:
                w[d // 2, hot] = 2.0 + hot
                v[d // 2, hot] = True
            dists.append((w, None))
            valids.append(v)
        want = fused_visual._max_distance(dists, valids)
        got = visual_max_distance_replay(dists, valids, g)
        assert torch.equal(want, got)
