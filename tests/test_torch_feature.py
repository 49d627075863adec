"""The port's `FeatureTracker` against the JAX package's, on the CPU.

Both are the same NumPy/BLAS engine, so ids, galleries and every internal
array must be equal, epoch for epoch: the norm-windowed exact-pair path
(clustered tracks, enough lanes), the one-sgemm path (small frames,
overlapping norms), the centred sgemm (large norms), the general path
(cosine, or min_votes > 1), and the sequential merge when two candidates
win one track.
"""

import numpy as np
import pytest

from similari_tpu.trackers.feature import FeatureTracker as JaxFeatureTracker
from similari_tpu_torch import FeatureTracker

from torch_parity import one_cpu_thread

one_cpu_thread()

DIM = 32


def _epochs(kind, steps=8):
    """(features per epoch, tracker keywords)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind in ("windowed", "small"):  # the reference bench: tracks far apart
        n = 80 if kind == "windowed" else 6
        base = np.zeros((n, DIM), np.float32)
        base[:, 0] = 1000.0 * np.arange(n)
        eps = [base + rng.uniform(-0.1, 0.1, base.shape).astype(np.float32)
               for _ in range(steps)]
        eps[3] = np.concatenate([eps[3], eps[3][:2] + 0.5])  # 2 new objects
        return eps, {}
    if kind == "overlapping":  # similar norms: the window gives up
        ident = rng.normal(size=(60, DIM)).astype(np.float32) * 20
        return [ident + rng.normal(size=ident.shape).astype(np.float32)
                for _ in range(steps)], {}
    if kind == "large_norm":
        ident = rng.normal(size=(12, DIM))
        ident = (ident / np.linalg.norm(ident, axis=1, keepdims=True)
                 * 4e5).astype(np.float32)
        return [ident + rng.normal(size=ident.shape).astype(np.float32)
                for _ in range(steps)], {}
    if kind == "cosine":
        ident = rng.normal(size=(20, DIM)).astype(np.float32)
        return [ident + 0.05 * rng.normal(size=ident.shape).astype(np.float32)
                for _ in range(steps)], dict(metric="cosine",
                                             max_distance=0.2)
    if kind == "two_votes":
        ident = rng.normal(size=(20, DIM)).astype(np.float32) * 5
        return [ident + 0.3 * rng.normal(size=ident.shape).astype(np.float32)
                for _ in range(steps)], dict(min_votes=2, max_distance=8.0)
    if kind == "shared_winner":  # two candidates near one track
        ident = rng.normal(size=(8, DIM)).astype(np.float32) * 50
        eps = [ident + rng.normal(size=ident.shape).astype(np.float32)
               for _ in range(steps)]
        for e in eps[2:]:
            e[1] = e[0] + 0.5
        return eps, dict(max_distance=30.0)
    raise KeyError(kind)


KINDS = ("windowed", "small", "overlapping", "large_norm", "cosine",
         "two_votes", "shared_winner")


@pytest.mark.parametrize("kind", KINDS)
def test_feature_tracker_matches_jax(kind):
    epochs, kw = _epochs(kind)
    jt = JaxFeatureTracker(DIM, gallery=3, initial_capacity=16, **kw)
    pt = FeatureTracker(DIM, gallery=3, initial_capacity=16, **kw)
    merged = 0
    for s, feats in enumerate(epochs):
        ij, ip = jt.predict(feats), pt.predict(feats)
        np.testing.assert_array_equal(ip, ij, err_msg=f"epoch {s}")
        merged += int(s > 0 and (ip <= len(epochs[0])).any())
        for name in ("_feats", "_norms", "_live", "_count", "_ids",
                     "_active"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(jt, name), err_msg=name)
        assert (pt._used, pt._next_id, pt._max_norm) == (
            jt._used, jt._next_id, jt._max_norm)
    # tracks were matched, not only created; with two votes needed a track
    # of one observation never wins, so every candidate starts a track
    assert merged if kind != "two_votes" else pt._next_id == 20 * len(epochs)
    assert len(pt) == len(jt) and pt.capacity == jt.capacity
    np.testing.assert_array_equal(pt.track_ids(), jt.track_ids())
    for tid in pt.track_ids()[:10]:
        np.testing.assert_array_equal(pt.gallery_of(int(tid)),
                                      jt.gallery_of(int(tid)))
    assert pt.predict(np.zeros((0, DIM), np.float32)).shape == (0,)
    assert pt.wasted().shape == (0,)


def test_clustered_tracks_keep_their_ids():
    """The bench's workload: every object keeps its id, the gallery holds
    the newest 3 observations in ring order."""
    epochs, _ = _epochs("windowed", steps=5)
    ft = FeatureTracker(DIM, gallery=3, initial_capacity=16)
    first = ft.predict(epochs[0])
    np.testing.assert_array_equal(first, np.arange(1, 81))
    for feats in epochs[1:3]:
        np.testing.assert_array_equal(ft.predict(feats)[:80], first)
    np.testing.assert_array_equal(ft.gallery_of(1), np.stack(
        [e[0] for e in epochs[:3]]))
    with pytest.raises(KeyError):
        ft.gallery_of(10_000)
