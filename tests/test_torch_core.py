"""The port's generic engine (`similari_tpu_torch.core`) against the JAX
package's (`similari_tpu.core`), on the CPU.

Both packages run the same operations, one case per test of
tests/test_core_engine.py: track ids, record order, `attribute_metric`,
error types and voting winners must be equal.  `feature_distance` is held
to FEATURE_RTOL / FEATURE_ATOL: the port's store computes it in PyTorch on
the store's device (`device="cpu"` here), the JAX package in NumPy, and
the f32 gram form `qq - 2 q.g + gg` rounds differently in the two.  The
voting streams keep every distance at least MARGIN away from the voting's
max_distance, so no winner hangs on that rounding.

Also: the store's device rule, the counted bulk fallbacks, the arrays
query at a few hundred tracks (cosine and euclidean, only_baked), the
fixtures' generators, and the port's `FeatureTracker` against the port's
core, as tests/test_feature_tracker.py holds the JAX package's.
"""

import types

import numpy as np
import pytest
import torch

import similari_tpu.core as jcore
import similari_tpu.core.examples as jex
import similari_tpu.utils.bbox as jbbox
import similari_tpu_torch.core as pcore
import similari_tpu_torch.core.examples as pex
import similari_tpu_torch.utils.bbox as pbbox
from similari_tpu_torch.trackers.feature import FeatureTracker

from torch_parity import one_cpu_thread

one_cpu_thread()

FEATURE_RTOL, FEATURE_ATOL = 1e-5, 1e-4
MARGIN = 1.0  # least gap between a voted distance and max_distance

JAX = types.SimpleNamespace(core=jcore, ex=jex, bbox=jbbox, dev={})
PORT = types.SimpleNamespace(core=pcore, ex=pex, bbox=pbbox,
                             dev={"device": "cpu"})


def both(scenario):
    return scenario(JAX), scenario(PORT)


def make_store(p, metric=None, attrs=None, shards=2):
    return (
        p.core.TrackStoreBuilder(shards, **p.dev)
        .default_attributes(attrs or p.ex.SimpleAttrs())
        .metric(metric or p.ex.SimpleMetric())
        .notifier(p.core.NoopNotifier())
        .build()
    )


def obs(p, attr, feat, update=True):
    b = p.core.ObservationBuilder(0).observation_attributes(attr)
    if feat is not None:
        b = b.observation(feat)
    if update:
        b = b.track_attributes_update(p.ex.SimpleAttributeUpdate())
    return b.build()


def rec_key(r):
    return (r.from_id, r.to_id, r.attribute_metric)


def assert_records_equal(a, b):
    """Same pairs in the same order, attribute metrics exactly equal,
    feature distances within the stated tolerance."""
    assert [rec_key(r) for r in b] == [rec_key(r) for r in a]
    fa = [r.feature_distance for r in a]
    fb = [r.feature_distance for r in b]
    assert [x is None for x in fb] == [x is None for x in fa]
    np.testing.assert_allclose(
        [x for x in fb if x is not None], [x for x in fa if x is not None],
        rtol=FEATURE_RTOL, atol=FEATURE_ATOL)


def error_key(errors):
    return [(type(e).__name__, str(e)) for e in errors]


# --------------------------------------------------------------------------
# tests/test_core_engine.py, case for case
# --------------------------------------------------------------------------

def test_track_add_observation_and_attrs():
    def run(p):
        t = make_store(p).new_track(1).observation(
            obs(p, 0.3, [1.0, 0.0, 0.0])).build()
        return (t.get_track_id(), t.attributes.set,
                [o.feature().tolist() for o in t.get_observations(0)],
                t.get_merge_history(), t.get_feature_classes())

    j, q = both(run)
    assert q == j


def test_attr_update_rollback():
    def run(p):
        t = make_store(p).new_track(1).observation(
            obs(p, 0.3, [1.0, 0.0, 0.0])).build()
        with pytest.raises(p.ex.SetError) as err:
            t.add_observation(0, 0.2, [0.0, 1.0, 0.0],
                              p.ex.SimpleAttributeUpdate())
        return (str(err.value), len(t.get_observations(0)), t.attributes.set)

    j, q = both(run)
    assert q == j


def test_optimize_failure_rolls_back():
    """`add_observation` restores attributes, observations and metric when
    `optimize` raises; `merge` restores them when the attribute merge
    raises."""
    def run(p):
        class Failing(p.ex.SimpleMetric):
            def optimize(self, feature_class, merge_history, attrs,
                         observations, prev_length, is_merge):
                if len(observations) > 1:
                    raise ValueError("no second observation")

        store = make_store(p, metric=Failing())
        t = store.new_track(1).observation(obs(p, 0.3, [1.0, 0.0])).build()
        with pytest.raises(ValueError):
            t.add_observation(0, 0.4, [0.0, 1.0])
        other = store.new_track(2).observation(
            obs(p, 0.5, [0.0, 1.0], update=False)).build()
        with pytest.raises(p.ex.Incompatible):
            t.merge(other, [0])
        return (len(t.get_observations(0)), t.attributes.set,
                t.get_merge_history())

    j, q = both(run)
    assert q == j


def test_distances_and_incompatibility():
    def run(p):
        store = make_store(p)

        def mk(tid, attr, feat, update=True):
            return store.new_track(tid).observation(
                obs(p, attr, feat, update)).build()

        t1 = mk(1, 0.3, [1.0, 0.0, 0.0])
        t2 = mk(2, 0.4, [0.0, 1.0, 0.0])
        dists = t1.distances(t2, 0)
        t3 = mk(3, 0.5, [0.0, 0.0, 1.0], update=False)
        with pytest.raises(p.core.IncompatibleAttributes) as err:
            t1.distances(t3, 0)
        with pytest.raises(p.core.ObservationForClassNotFound):
            t1.distances(t2, 5)
        return dists, str(err.value)

    (dj, ej), (dq, eq) = both(run)
    assert_records_equal(dj, dq)
    assert eq == ej
    assert dq[0].feature_distance == pytest.approx(np.sqrt(2), abs=1e-5)


@pytest.mark.parametrize("merge_history", [True, False])
def test_track_merge(merge_history):
    def run(p):
        store = make_store(p)
        t1 = store.new_track(1).observation(obs(p, 0.3, [1.0, 0.0, 0.0])).build()
        t2 = store.new_track(2).observation(obs(p, 0.4, [0.0, 1.0, 0.0])).build()
        t1.merge(t2, [0], merge_history)
        return ([o.attr() for o in t1.get_observations(0)],
                t1.get_merge_history())

    j, q = both(run)
    assert q == j


def test_store_foreign_distances_and_usable():
    def run(p):
        store = make_store(p)
        for tid, attr in ((1, 0.3), (2, 0.5), (3, 0.7)):
            store.add_track(store.new_track(tid).observation(
                obs(p, attr, [attr, 0.0, 0.0])).build())
        store.add(4, 0, 0.9, [0.9, 0.0, 0.0])  # never set: Pending
        cand = store.new_track(100).observation(
            obs(p, 0.4, [0.4, 0.0, 0.0])).build()
        dists, errs = store.foreign_track_distances([cand], 0, False)
        baked, errs_b = store.foreign_track_distances([cand], 0, True)
        usable = [(t, s.name) for t, s in store.find_usable()]
        return dists, baked, error_key(errs + errs_b), usable, \
            store.shard_stats()

    (dj, bj, *rest_j), (dq, bq, *rest_q) = both(run)
    assert_records_equal(dj, dq)
    assert_records_equal(bj, bq)
    assert rest_q == rest_j
    assert {d.to_id for d in dq} == {1, 2, 3}


def test_store_merge_and_fetch():
    def run(p):
        store = make_store(p)
        for tid, attr in ((1, 0.3), (2, 0.5), (3, 0.6)):
            store.add_track(store.new_track(tid).observation(
                obs(p, attr, [attr, 0.0, 0.0])).build())
        with pytest.raises(p.core.DuplicateTrackId):
            store.add_track(store.new_track(1).build())
        store.merge_owned(1, 2)
        errors = []
        for call in (lambda: store.merge_owned(1, 42),
                     lambda: store.merge_external(42, store.get(3)),
                     lambda: store.merge_external(3, store.get(3))):
            with pytest.raises(Exception) as err:
                call()
            errors.append(type(err.value).__name__)
        out = (store.get(2) is None, len(store.get(1).get_observations(0)),
               store.get(1).get_merge_history(), errors)
        fetched = store.fetch_tracks([1, 77])
        return out + (len(fetched), len(store))

    j, q = both(run)
    assert q == j
    assert q[3] == ["TrackNotFound", "TrackNotFound", "SameTrackCalculation"]


def test_iou_metric_track():
    def run(p):
        store = (p.core.TrackStoreBuilder(1, **p.dev)
                 .default_attributes(p.ex.BBoxAttributes())
                 .metric(p.ex.IOUMetric(history=3))
                 .notifier(p.core.NoopNotifier()).build())

        def mk(tid, boxes):
            b = store.new_track(tid)
            for box in boxes:
                b = b.observation(
                    p.core.ObservationBuilder(0)
                    .observation_attributes(p.bbox.BoundingBox(*box))
                    .track_attributes_update(p.ex.BBoxAttributesUpdate())
                    .build())
            return b.build()

        t1 = mk(1, [(0.0, 0.0, 5.0, 10.0), (0.5, 0.2, 5.0, 10.0),
                    (1.0, 0.4, 5.0, 10.0), (1.5, 0.6, 5.0, 10.0)])
        t2 = mk(2, [(0.3, 0.3, 5.1, 10.0), (40.0, 0.0, 5.0, 10.0)])
        return t1.distances(t2, 0), len(t1.get_observations(0)), \
            len(t1.attributes.bboxes)

    (dj, *rj), (dq, *rq) = both(run)
    assert_records_equal(dj, dq)
    assert rq == rj == [3, 4]
    assert dq[0].attribute_metric > 0.8


def _rec(core, f, t, d):
    return core.ObservationMetricOk(f, t, None, d)


TOPN_STREAMS = {
    "one": [(0, 1, 0.2)],
    "two": [(0, 1, 0.2), (0, 1, 0.3)],
    "filtered_raises_max": [(0, 1, 0.2), (0, 1, 0.4)],
    "six_tracks": [(0, 1, 0.2), (0, 1, 0.22), (0, 2, 0.21), (0, 2, 0.2),
                   (0, 3, 0.22), (0, 3, 0.2), (0, 4, 0.23), (0, 4, 0.3),
                   (0, 5, 0.24), (0, 5, 0.3), (0, 6, 0.25), (0, 6, 0.5)],
    "two_queries": [(0, 1, 0.2), (0, 1, 0.22), (0, 2, 0.21), (0, 2, 0.2),
                    (0, 3, 0.22), (0, 3, 0.2), (7, 4, 0.23), (7, 4, 0.3),
                    (7, 5, 0.24), (7, 5, 0.3), (7, 6, 0.25), (7, 6, 0.5)],
}


def _winner_key(winners):
    return {k: [(e.query_track, e.winner_track, round(e.weight, 9))
                for e in v] for k, v in winners.items()}


@pytest.mark.parametrize("stream", sorted(TOPN_STREAMS))
def test_topn_voting_goldens(stream):
    def run(p):
        recs = [_rec(p.core, *r) for r in TOPN_STREAMS[stream]]
        return p.core.TopNVoting(5, 0.32, 1).winners(recs)

    j, q = both(run)
    assert _winner_key(q) == _winner_key(j)
    assert all(a == b for k in j for a, b in zip(q[k], j[k]))


def test_best_fit_greedy_claim():
    def run(p):
        recs = [_rec(p.core, 10, 1, 0.1), _rec(p.core, 20, 1, 0.2),
                _rec(p.core, 20, 2, 0.4), _rec(p.core, 30, 3, 0.5)]
        return p.core.BestFitVoting(1.0, 1).winners(recs)

    j, q = both(run)
    assert _winner_key(q) == _winner_key(j)
    assert q[20][0].winner_track == 20


def test_sort_voting():
    def run(p):
        recs = [p.core.ObservationMetricOk(1, 10, 0.9, None),
                p.core.ObservationMetricOk(2, 10, 0.8, None),
                p.core.ObservationMetricOk(2, 11, 0.7, None),
                p.core.ObservationMetricOk(3, 11, 0.1, None)]
        return p.core.voting.SortVoting(0.3, 3, 2).winners(recs)

    j, q = both(run)
    assert q == j


def _feature_store(p, metric, n_tracks=4, per_track=3, dim=16, seed=7):
    store = make_store(p, metric=metric)
    rng = np.random.default_rng(seed)
    for tid in range(1, n_tracks + 1):
        for k in range(per_track):
            store.add(tid, 0, float(tid) * 0.1,
                      rng.normal(size=dim).astype(np.float32),
                      p.ex.SimpleAttributeUpdate() if k == 0 else None)
    return store


def _candidate(p, store, attr, feats, tid=99):
    b = store.new_track(tid)
    for i, f in enumerate(feats):
        b = b.observation(obs(p, attr, f, update=i == 0))
    return b.build()


@pytest.mark.parametrize("metric", ["SimpleMetric", "BatchedSimpleMetric"])
@pytest.mark.parametrize("cand_obs", [1, 3])
def test_batched_feature_sweep_matches_per_pair_metric(metric, cand_obs):
    """Plain and batched metric, one- and three-observation candidates:
    the record streams of both packages agree, and the batched one agrees
    with the plain one."""
    feats = np.random.default_rng(3).normal(size=(cand_obs, 16)).astype(
        np.float32)

    def run(p):
        store = _feature_store(p, getattr(p.ex, metric)())
        cand = _candidate(p, store, 0.25, feats)
        dists, errs = store.foreign_track_distances([cand], 0, False)
        return dists, error_key(errs)

    (dj, ej), (dq, eq) = both(run)
    assert ej == eq == []
    assert len(dq) == 12 * cand_obs
    assert_records_equal(dj, dq)


def test_bulk_record_stream_parity_none_attrs_and_empty_class():
    def run(p):
        store = make_store(p, metric=p.ex.BatchedSimpleMetric())
        rng = np.random.default_rng(21)
        for tid in range(1, 6):
            for k in range(2):
                attr = None if tid % 2 == 0 else float(tid) * 0.1
                store.add(tid, 0, attr, rng.normal(size=16).astype(np.float32),
                          p.ex.SimpleAttributeUpdate() if k == 0 else None)
        t6 = store.new_track(6).observation(
            obs(p, 0.6, rng.normal(size=16).astype(np.float32))).build()
        t6.observations[0] = []
        store.add_track(t6)
        store.add_track(store.new_track(7).observation(  # class 1 only
            p.core.ObservationBuilder(1).observation_attributes(0.7)
            .observation(rng.normal(size=16).astype(np.float32))
            .track_attributes_update(p.ex.SimpleAttributeUpdate()).build()
        ).build())
        cand = _candidate(p, store, 0.25,
                          [rng.normal(size=16).astype(np.float32)])
        dists, errs = store.foreign_track_distances([cand], 0, False)
        return dists, error_key(errs), getattr(store, "bulk_fallbacks", 0)

    (dj, ej, _), (dq, eq, fallbacks) = both(run)
    assert_records_equal(dj, dq)
    assert eq == ej and len(eq) == 1  # track 7 has no class 0
    assert sum(r.attribute_metric is None for r in dq) == 4
    assert fallbacks == 0


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("case", ["compatible_raises", "records_raise",
                                  "records_none", "bulk"])
def test_bulk_fallbacks_are_counted(case):
    """The bulk record stream is left for the per-pair loop only where it
    must be; every departure is counted in `bulk_fallbacks`, and the record
    stream and error list stay equal to the JAX package's."""
    def run(p):
        class Attrs(p.ex.SimpleAttrs):
            def compatible(self, other):
                if case == "compatible_raises":
                    raise _Boom("boom")
                return super().compatible(other)

        class Metric(p.ex.BatchedSimpleMetric):
            def batch_records(self, *args):
                if case == "records_raise":
                    raise _Boom("records")
                if case == "records_none":
                    return None
                return super().batch_records(*args)

        store = make_store(p, metric=Metric())
        rng = np.random.default_rng(22)
        for tid in (1, 2, 3):
            store.add(tid, 0, 0.5, rng.normal(size=8).astype(np.float32),
                      p.ex.SimpleAttributeUpdate())
        cands = []
        for tid in (98, 99):
            c = _candidate(p, store, 0.5,
                           rng.normal(size=(2, 8)).astype(np.float32), tid)
            c.attributes = Attrs()
            c.attributes.set = True
            cands.append(c)
        dists, errs = store.foreign_track_distances(cands, 0, False)
        return dists, error_key(errs), getattr(store, "bulk_fallbacks", None)

    (dj, ej, _), (dq, eq, fallbacks) = both(run)
    assert_records_equal(dj, dq)
    assert eq == ej
    assert fallbacks == (0 if case == "bulk" else 2)
    if case == "compatible_raises":
        assert dq == [] and len(eq) == 6
    else:
        assert len(dq) == 2 * 3 * 2 and eq == []


@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
@pytest.mark.parametrize("only_baked", [False, True])
def test_store_arrays_query_matches_jax(kind, only_baked):
    """The arrays query at 300 tracks x 3 observations x 32-d: to_id and
    obs_ix equal, distances within tolerance, and the record API agrees;
    then a mutation invalidates the index."""
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(300, 3, 32)).astype(np.float32) * 4.0
    cand_feats = rng.normal(size=(3, 32)).astype(np.float32) * 4.0

    def run(p):
        metric = p.ex.BatchedSimpleMetric()
        metric.supports_batch_features = kind
        store = make_store(p, metric=metric)
        for tid in range(300):
            for k in range(3):
                # every 7th track stays Pending, every 5th set to attrs 0.1
                update = (p.ex.SimpleAttributeUpdate()
                          if k == 0 and tid % 7 else None)
                store.add(tid, 0, 0.1 * (tid % 5), feats[tid, k], update)
        cand = _candidate(p, store, 0.5, cand_feats, tid=1000)
        first = store.foreign_track_distances_arrays(cand, 0, only_baked)
        store.add(5000, 0, 1.0, feats[0, 0], p.ex.SimpleAttributeUpdate())
        second = store.foreign_track_distances_arrays(cand, 0, only_baked)
        recs, errs = store.foreign_track_distances([cand], 0, only_baked)
        return first, second, recs, error_key(errs)

    (fj, sj, rj, ej), (fq, sq, rq, eq) = both(run)
    for a, b in ((fj, fq), (sj, sq)):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert b[2].dtype == np.float32 and b[2].shape == a[2].shape
        np.testing.assert_allclose(b[2], a[2], rtol=FEATURE_RTOL,
                                   atol=FEATURE_ATOL)
    assert 5000 in sq[0].tolist() and sq[2].shape[1] == fq[2].shape[1] + 1
    assert_records_equal(rj, rq)
    assert eq == ej


def test_store_device_rule():
    """`device=None` means CUDA and raises without it; the feature index
    lives on the store's device."""
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: device=None is valid there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcore.TrackStoreBuilder(1).default_attributes(
            pex.SimpleAttrs()).metric(pex.SimpleMetric()).build()
    with pytest.raises(RuntimeError, match="CUDA"):
        pcore.TrackStore(1, pex.SimpleAttrs(), pex.SimpleMetric())
    store = _feature_store(PORT, pex.BatchedSimpleMetric())
    assert store.device == torch.device("cpu")
    index = store._feature_index(0)
    assert isinstance(index.rows, torch.Tensor)
    assert index.rows.dtype == torch.float32 and index.rows.shape == (12, 16)


def test_lookup_and_owned_distances():
    def run(p):
        class ById(p.core.LookupRequest):
            def lookup(self, attributes, observations, merge_history):
                return len(observations.get(0, [])) > 1

        store = _feature_store(p, p.ex.BatchedSimpleMetric(), per_track=2)
        store.add(9, 0, 0.9, np.zeros(16, np.float32))
        looked = [(t, getattr(s, "name", type(s).__name__))
                  for t, s in store.lookup(ById())]
        dists, errs = store.owned_track_distances([1, 2], 0, False)
        return looked, dists, error_key(errs), sorted(store.tracks)

    (lj, dj, *rj), (lq, dq, *rq) = both(run)
    assert lq == lj
    assert_records_equal(dj, dq)
    assert rq == rj


# --------------------------------------------------------------------------
# fixtures and the feature-tracker bench shape
# --------------------------------------------------------------------------

def test_generators_match_jax():
    def run(p):
        fg = p.ex.FeatGen(2.0, 8, 0.1, seed=4)
        fg2 = p.ex.FeatGen2(1.0, 2.0, 0.3, seed=5)
        bg = p.ex.BoxGen2.new_monotonous(10.0, 20.0, 5.0, 8.0, 1.0, 0.2, seed=6)
        return ([next(fg).feature().tolist() for _ in range(3)],
                [(o.attr(), o.feature().tolist())
                 for o in (next(fg2) for _ in range(3))],
                [(b.left, b.top, b.width, b.height)
                 for b in (next(bg) for _ in range(3))])

    j, q = both(run)
    assert q == j


def _bench_store(p):
    """The reference's feature-tracker bench engine: unbound attributes, a
    euclidean metric keeping the newest 3 observations, TopN(1, 100, 1)."""
    class Euclid(p.core.ObservationMetric):
        def metric(self, mq):
            a = mq.candidate_observation.feature()
            b = mq.track_observation.feature()
            if a is None or b is None:
                return None
            return (None, float(np.linalg.norm(a - b)))

        def optimize(self, feature_class, merge_history, attrs, observations,
                     prev_length, is_merge):
            del observations[:-3]

        def postprocess_distances(self, unfiltered):
            return [x for x in unfiltered if x.feature_distance is not None
                    and x.feature_distance < 100.0]

    return (p.core.TrackStoreBuilder(1, **p.dev)
            .default_attributes(p.ex.UnboundAttrs()).metric(Euclid()).build())


class CoreOracle:
    """Fresh candidate per feature, TopNVoting(1, 100, 1), merge winners,
    add losers (tests/test_feature_tracker.py's oracle on either package)."""

    def __init__(self, p):
        self.p = p
        self.store = _bench_store(p)
        self.voting = p.core.TopNVoting(1, 100.0, 1)
        self.seq = 1_000_000
        self.alias = {}

    def predict(self, feats):
        tracks = []
        for f in feats:
            self.seq += 1
            tracks.append(self.store.new_track(self.seq).observation(
                self.p.core.ObservationBuilder(0).observation(f)
                .track_attributes_update(self.p.ex.UnboundAttributeUpdate())
                .build()).build())
        dists, errs = self.store.foreign_track_distances(tracks, 0, False)
        assert not errs
        assert all(abs(d.feature_distance - 100.0) >= MARGIN for d in dists)
        winners = self.voting.winners(dists)
        out = []
        for t in tracks:
            w = winners.get(t.track_id)
            if w:
                self.store.merge_external(w[0].winner_track, t, None, True)
                out.append(self.alias[w[0].winner_track])
            else:
                self.store.add_track(t)
                self.alias[t.track_id] = len(self.alias) + 1
                out.append(self.alias[t.track_id])
        return np.asarray(out)


def _drifting(seed, epochs, n, f, drift=0.1, spacing=1000.0):
    rng = np.random.default_rng(seed)
    base = np.zeros((n, f), np.float32)
    base[:, 0] = spacing * np.arange(n)
    out = []
    for _ in range(epochs):
        base = base + rng.uniform(-drift, drift, (n, f)).astype(np.float32)
        out.append(base.copy())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_feature_tracker_matches_port_core(seed):
    """The port's FeatureTracker, the port's core and the JAX package's
    core give the same ids epoch for epoch."""
    stream = _drifting(seed, epochs=6, n=8, f=32)
    fast = FeatureTracker(32, gallery=3, max_distance=100.0, min_votes=1)
    port, ref = CoreOracle(PORT), CoreOracle(JAX)
    for feats in stream:
        ids = fast.predict(feats)
        np.testing.assert_array_equal(port.predict(feats), ids)
        np.testing.assert_array_equal(ref.predict(feats), ids)
    assert len(fast) == len(port.store) == 8


def test_topn_bench_winners_match_jax():
    """The bench shape cut to 20 objects x 64-d, 8 epochs of
    TopNVoting(1, 100, 1) through a batched-metric store: the winners of
    every epoch are equal."""
    stream = _drifting(2, epochs=8, n=20, f=64)

    def run(p):
        metric = p.ex.BatchedSimpleMetric()
        store = (p.core.TrackStoreBuilder(1, **p.dev)
                 .default_attributes(p.ex.UnboundAttrs()).metric(metric)
                 .build())
        voting = p.core.TopNVoting(1, 100.0, 1)
        out = []
        for e, feats in enumerate(stream):
            cands = [store.new_track(10_000 * (e + 1) + i).observation(
                p.core.ObservationBuilder(0).observation(f).build()).build()
                for i, f in enumerate(feats)]
            dists, errs = store.foreign_track_distances(cands, 0, False)
            assert not errs
            assert all(abs(d.feature_distance - 100.0) >= MARGIN
                       for d in dists)
            win = voting.winners(dists)
            out.append({k: v[0].winner_track for k, v in win.items()})
            for i, c in enumerate(cands):
                if c.track_id in win:
                    store.merge_external(win[c.track_id][0].winner_track, c,
                                         None, True)
                else:
                    store.add_track(c)
        return out, getattr(store, "bulk_fallbacks", 0)

    (wj, _), (wq, fallbacks) = both(run)
    assert wq == wj
    assert fallbacks == 0
