"""The port's `BatchSort` / `BatchVisualSort` against the JAX package's
device engines (`engine="device"`), on the CPU.

S=3 scenes of churning random walks, one scene absent from some
requests (its row steps with no valid detection at epoch 0).  Per scene:
ids (the per-scene id reservation included), lengths, voting types and
custom ids equal, predicted boxes within rtol 2e-4 / atol 1e-3; then idle
tracks and the waste after `skip_epochs_for_scene`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu_torch.ops import merge_inplace

from torch_parity import API_ATOL, API_RTOL, churn_stream, one_cpu_thread

one_cpu_thread()

SCENES = (4, 11, 2)  # scene ids, in the order requests add them
ABSENT = {3: 11, 4: 11, 6: 2}  # frame -> the scene missing from its request


def _scene_streams(steps, n, f, angle=0.0):
    out = {}
    for k, sid in enumerate(SCENES):
        rng = np.random.default_rng(70 + k)
        ident = rng.normal(size=(n, f)).astype(np.float32)
        frames = churn_stream(10 + k, steps, n, spread=300.0, churn=3,
                              angle=angle)
        out[sid] = [(b, c, (ident + 0.05 * rng.normal(size=(n, f))).astype(
            np.float32), rng.uniform(size=n) < 0.85) for b, c in frames]
    return out


def _box(pkg, row, conf):
    return pkg.Universal2DBox.new_with_confidence(
        float(row[0]), float(row[1]), float(row[2]) or None, float(row[3]),
        float(row[4]), float(conf))


def _sort_request(pkg, streams, s):
    req = pkg.SortPredictionBatchRequest()
    for sid in SCENES:
        if ABSENT.get(s) == sid:
            continue
        b, c, _, _ = streams[sid][s]
        for i in range(len(b)):
            req.add(sid, _box(pkg, b[i], c[i]), None if i % 4 == 0 else i)
    return req


def _visual_request(pkg, streams, s):
    req = pkg.VisualSortPredictionBatchRequest()
    for sid in SCENES:
        if ABSENT.get(s) == sid:
            continue
        b, c, f, fv = streams[sid][s]
        for i in range(len(b)):
            req.add(sid, pkg.VisualSortObservation(
                f[i] if fv[i] else None, 0.5 + 0.05 * i, _box(pkg, b[i], c[i]),
                i))
    return req


def _drain(result):
    out = {}
    while result.ready():
        sid, tracks = result.get()
        out[sid] = tracks
    return out


def _compare(rj, rp, s):
    assert list(rp) == list(rj), f"scenes frame {s}"
    for sid in rj:
        key = lambda t: (t.id, t.epoch, t.scene_id, t.length,  # noqa: E731
                         t.voting_type.name, t.custom_object_id)
        assert list(map(key, rp[sid])) == list(map(key, rj[sid])), (s, sid)
        np.testing.assert_allclose(
            [t.predicted_bbox.to_vec5() for t in rp[sid]],
            [t.predicted_bbox.to_vec5() for t in rj[sid]],
            rtol=API_RTOL, atol=API_ATOL, err_msg=f"pred {s} {sid}")
        assert [t.observed_bbox for t in rp[sid]] == [
            t.observed_bbox for t in rj[sid]]


def _lifecycle(jt, pt_tracker):
    for sid in SCENES:
        key = lambda t: (t.id, t.epoch, t.length,  # noqa: E731
                         t.voting_type.name, t.custom_object_id)
        assert sorted(map(key, pt_tracker.idle_tracks(sid))) == sorted(
            map(key, jt.idle_tracks(sid)))
    assert pt_tracker.current_epoch_with_scene(11) == \
        jt.current_epoch_with_scene(11)
    jt.skip_epochs_for_scene(11, 6)
    pt_tracker.skip_epochs_for_scene(11, 6)
    wkey = lambda w: (w.id, w.epoch, w.scene_id, w.length,  # noqa: E731
                      len(w.observed_boxes))
    wj, wp = jt.wasted(), pt_tracker.wasted()
    assert sorted(map(wkey, wp)) == sorted(map(wkey, wj)) and wp
    assert 11 in {w.scene_id for w in wp}
    assert pt_tracker.shard_stats() == jt.shard_stats()


@pytest.mark.parametrize("angle", [0.0, 0.5])
def test_batch_sort_matches_jax(angle):
    streams = _scene_streams(steps=8, n=10, f=4, angle=angle)

    def make(pkg, **kw):
        return pkg.BatchSort(bbox_history=2, max_idle_epochs=3,
                             method=pkg.PositionalMetricType.iou(0.3),
                             initial_capacity=16, **kw)

    jt, ptr = make(jx, engine="device"), make(pt, device="cpu")
    for s in range(8):
        rj = _drain(jt.predict(_sort_request(jx, streams, s)))
        rp = _drain(ptr.predict(_sort_request(pt, streams, s)))
        _compare(rj, rp, s)
    assert ptr._engine.T == jt._engine.T > 16
    _lifecycle(jt, ptr)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_batch_visual_sort_matches_jax(precision, monkeypatch):
    launches = []
    merge = merge_inplace.lane_merge_inplace
    monkeypatch.setattr(
        "similari_tpu_torch.parallel.mesh.lane_merge_inplace",
        lambda *a: (launches.append(1), merge(*a))[1])
    streams = _scene_streams(steps=8, n=10, f=6)

    def opts(pkg):
        return (pkg.VisualSortOptions()
                .visual_metric(pkg.VisualSortMetricType.euclidean(5.0))
                .visual_minimal_track_length(2).visual_max_observations(3)
                .max_idle_epochs(3).kept_history_length(2))

    jt = jx.BatchVisualSort(opts=opts(jx), initial_capacity=16,
                            engine="device")
    jt._engine.cfg = dataclasses.replace(jt._engine.cfg,
                                         feature_precision=precision)
    ptr = pt.BatchVisualSort(opts=opts(pt).feature_precision(precision),
                             initial_capacity=16, device="cpu")
    visual = 0
    for s in range(8):
        rj = _drain(jt.predict(_visual_request(jx, streams, s)))
        rp = _drain(ptr.predict(_visual_request(pt, streams, s)))
        _compare(rj, rp, s)
        visual += sum(t.voting_type == pt.VotingType.Visual
                      for v in rp.values() for t in v)
    assert visual > 0 and len(launches) == 2 * 8
    st = ptr._engine.state
    assert st.feats.dtype == st.hist_feat.dtype == (
        torch.bfloat16 if precision == "bf16" else torch.float32)
    _lifecycle(jt, ptr)


def test_batch_visual_sort_host_own_area_matches_jax():
    """Own-area gates with shares from the clipping oracle per scene."""
    streams = _scene_streams(steps=5, n=8, f=4)

    def opts(pkg):
        return (pkg.VisualSortOptions().visual_minimal_track_length(1)
                .visual_minimal_own_area_percentage_use(0.95)
                .own_area_backend("host"))

    jt = jx.BatchVisualSort(opts=opts(jx), engine="device")
    ptr = pt.BatchVisualSort(opts=opts(pt), device="cpu")
    for s in range(5):
        _compare(_drain(jt.predict(_visual_request(jx, streams, s))),
                 _drain(ptr.predict(_visual_request(pt, streams, s))), s)


def test_batch_engine_rule_and_single_use_requests():
    for cls in (pt.BatchSort, pt.BatchVisualSort):
        with pytest.raises(ValueError, match="engine"):
            cls(engine="xla", device="cpu")
    host = pt.BatchSort(method=pt.PositionalMetricType.iou(0.3),
                        engine="host", device="cpu")
    req = pt.SortPredictionBatchRequest()
    req.add(3, pt.Universal2DBox(10, 10, None, 1.0, 20))
    assert host.predict(req).get()[1][0].id == 1
    vhost = pt.BatchVisualSort(engine="host", device="cpu")
    req = pt.VisualSortPredictionBatchRequest()
    req.add(2, pt.VisualSortObservation(
        [1.0, 0.0], 1.0, pt.Universal2DBox(10, 10, None, 1.0, 20)))
    assert vhost.predict(req).get()[1][0].id == 1
    tr = pt.BatchSort(method=pt.PositionalMetricType.iou(0.3), device="cpu")
    req = pt.SortPredictionBatchRequest()
    req.add(0, pt.Universal2DBox(10, 10, None, 1.0, 20))
    res = tr.predict(req)
    assert res.batch_size() == 1 and res.get()[1][0].id == 1
    with pytest.raises(RuntimeError, match="no more"):
        res.get()
    with pytest.raises(RuntimeError, match="already consumed"):
        tr.predict(req)
    with pytest.raises(RuntimeError, match="already consumed"):
        req.add(0, pt.Universal2DBox(10, 10, None, 1.0, 20))


def test_batch_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (pt.BatchSort, pt.BatchVisualSort):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
