"""The port's trackers with engine="host" against the JAX package's
engine="host" trackers, on the CPU.

`Sort`, `VisualSort`, `BatchSort` and `BatchVisualSort` over many calls
that grow the capacity (from 8 or 16), churn objects, auto-waste
(`set_auto_waste`) and end with idle tracks and the waste:

* against the JAX package's default host engine (native C++ steps, the
  port's own C++ steps on this side), ids, slots, lengths, voting types
  and predicted boxes equal call for call and every scene's state
  bit-equal at the end;
* with the JAX package's native steps switched off (monkeypatch; its NumPy
  steps against the port's C++ ones), ids, slots, lengths and voting types
  equal, predicted boxes within tests/test_host_sort.py's rtol 2e-4 /
  atol 1e-3.

The stores' native step sessions survive (are rebuilt across) the
capacity growing from 8 or 16, the feature dimension growing and the
oriented flip.

Also: a bf16 `VisualSort` under "host" runs the device step, as the JAX
package's does; the interactive runners on either engine; the `read_gt` /
`write_csv` round trip.
"""

import dataclasses

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu import native
from similari_tpu.eval import mot as jmot
from similari_tpu_torch.eval import mot as pmot

from torch_parity import (API_ATOL, API_RTOL, churn_stream, jax_state_dict,
                          one_cpu_thread)

one_cpu_thread()

PATHS = ("numpy", "native")


def _path(path, monkeypatch):
    """Switch the JAX package's native steps off for the NumPy path."""
    if path == "numpy":
        monkeypatch.setattr(native, "sort_step_available", lambda: False)
        monkeypatch.setattr(native, "visual_step_available", lambda: False)
    elif not (native.sort_step_available()
              and native.visual_step_available()):
        pytest.skip("the JAX package's native steps did not build")


def _check_out(oj, op, s, exact):
    assert oj[0] == op[0], f"epoch {s}"
    for i, (a, b) in enumerate(zip(op[1:], oj[1:])):
        if a.dtype.kind == "f" and not exact:
            np.testing.assert_allclose(a, b, rtol=API_RTOL, atol=API_ATOL,
                                       err_msg=f"output {i} call {s}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"output {i} call {s}")


def _check_state(jt, ptr, exact):
    for sid, store in ptr._scenes.items():
        a = jax_state_dict(jt._scenes[sid].state)
        b = jax_state_dict(store.state)
        for k in a:
            if k == "kf":
                continue
            if exact or a[k].dtype.kind in "biu":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        if exact:
            for n in a["kf"]:
                np.testing.assert_array_equal(b["kf"][n], a["kf"][n])


def _check_waste(jt, ptr):
    for sid in sorted(ptr._scenes):
        ij = jt.idle_tracks_with_scene(sid)
        ip = ptr.idle_tracks_with_scene(sid)
        assert [(t.id, t.epoch, t.length, t.custom_object_id,
                 t.voting_type.name) for t in ip] == [
            (t.id, t.epoch, t.length, t.custom_object_id, t.voting_type.name)
            for t in ij]
    for sid in sorted(ptr._scenes):
        jt.skip_epochs_for_scene(sid, 10)
        ptr.skip_epochs_for_scene(sid, 10)
    wj = sorted(jt.wasted(), key=lambda w: (w.scene_id, w.id))
    wp = sorted(ptr.wasted(), key=lambda w: (w.scene_id, w.id))
    assert [(w.id, w.scene_id, w.epoch, w.length, len(w.observed_boxes))
            for w in wp] == [(w.id, w.scene_id, w.epoch, w.length,
                              len(w.observed_boxes)) for w in wj]
    assert wp and ptr.shard_stats() == jt.shard_stats() == [0]
    return wp


# --------------------------------------------------------------------------
# Sort
# --------------------------------------------------------------------------

def _sort(pkg, kind, **kw):
    method = (pkg.PositionalMetricType.iou(0.3) if kind == "iou"
              else pkg.PositionalMetricType.maha())
    stc = pkg.SpatioTemporalConstraints()
    stc.add_constraints([(2, 3.0)])
    extra = {} if pkg is jx else dict(device="cpu")
    tr = pkg.Sort(shards=1, bbox_history=3, max_idle_epochs=2, method=method,
                  spatio_temporal_constraints=stc, initial_capacity=8,
                  engine="host", **kw, **extra)
    tr.set_auto_waste(4)
    return tr


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind,angle", [("iou", 0.0), ("maha", 0.0),
                                        ("iou", 0.8)])
def test_sort_host_engine_matches_jax(path, kind, angle, monkeypatch):
    _path(path, monkeypatch)
    exact = path == "native"
    jt, ptr = _sort(jx, kind), _sort(pt, kind)
    frames = churn_stream(3, steps=24, n=14, spread=500.0, churn=4,
                          angle=angle)
    for s, (boxes, conf) in enumerate(frames):
        if s == 7:  # an empty call ticks the epoch and the auto-waste
            assert jt.predict([]) == ptr.predict([]) == []
            continue
        scene = s % 2  # two scenes, one id counter
        cids = [None if i % 3 == 0 else 100 * s + i for i in range(len(boxes))]
        if s % 5 == 0:
            objs = [(jx.Universal2DBox.from_vec5(b, float(c)), k)
                    for b, c, k in zip(boxes, conf, cids)]
            tj = jt.predict_with_scene(scene, objs)
            tp = ptr.predict_with_scene(scene, [
                (pt.Universal2DBox.from_vec5(b, float(c)), k)
                for b, c, k in zip(boxes, conf, cids)])
            assert [(t.id, t.length, t.custom_object_id) for t in tp] == [
                (t.id, t.length, t.custom_object_id) for t in tj]
            continue
        _check_out(jt.predict_arrays(scene, boxes, conf, cids),
                   ptr.predict_arrays(scene, boxes, conf, cids), s, exact)
    store = ptr._scenes[0]
    assert store.host and isinstance(store.state.active, np.ndarray)
    assert store.state.capacity == jt._scenes[0].state.capacity > 8
    _check_state(jt, ptr, exact)
    _check_waste(jt, ptr)


# --------------------------------------------------------------------------
# VisualSort
# --------------------------------------------------------------------------

def _visual_frames(seed, steps, n, f, angle=0.0, grow_at=None):
    rng = np.random.default_rng(seed + 50)
    ident = rng.normal(size=(n, f + 4)).astype(np.float32)
    out = []
    for s, (boxes, conf) in enumerate(churn_stream(
            seed, steps, n, spread=250.0, churn=3, angle=angle)):
        width = f + 4 if grow_at is not None and s >= grow_at else f
        feat = (ident[:, :width] + 0.05 * rng.normal(size=(n, width))
                ).astype(np.float32)
        fvalid = rng.uniform(size=n) < 0.85
        qual = rng.uniform(0.3, 1.0, n).astype(np.float32)
        out.append((boxes, conf, feat, fvalid, qual))
    return out


def _visual_opts(pkg, metric="euclidean", own_area=None):
    o = (pkg.VisualSortOptions()
         .visual_metric(pkg.VisualSortMetricType.euclidean(5.0)
                        if metric == "euclidean"
                        else pkg.VisualSortMetricType.cosine(0.8))
         .positional_metric(pkg.PositionalMetricType.iou(0.3))
         .visual_minimal_track_length(2)
         .visual_max_observations(3)
         .max_idle_epochs(3)
         .kept_history_length(2))
    if own_area is not None:
        o = (o.visual_minimal_own_area_percentage_use(0.6)
             .visual_minimal_own_area_percentage_collect(0.6)
             .own_area_backend(own_area))
    return o


def _visual(pkg, **kw):
    extra = {} if pkg is jx else dict(device="cpu")
    tr = pkg.VisualSort(1, _visual_opts(pkg, **kw), initial_capacity=16,
                        engine="host", **extra)
    tr.set_auto_waste(5)
    return tr


VISUAL_CASES = {
    "euclid": dict(),
    "cosine_oriented": dict(metric="cosine", angle=0.6),
    "own_area_device": dict(own_area="device"),
    "own_area_host": dict(own_area="host"),
}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(VISUAL_CASES))
def test_visual_host_engine_matches_jax(path, case, monkeypatch):
    _path(path, monkeypatch)
    exact = path == "native"
    kw = dict(VISUAL_CASES[case])
    angle = kw.pop("angle", 0.0)
    jt, ptr = _visual(jx, **kw), _visual(pt, **kw)
    votes = 0
    for s, (boxes, conf, feat, fvalid, qual) in enumerate(_visual_frames(
            1, steps=16, n=12, f=8, angle=angle, grow_at=9)):
        cids = list(range(len(boxes)))
        if s % 6 == 5:  # through VisualSortObservationSet
            sets = []
            for pkg in (jx, pt):
                obs = pkg.VisualSortObservationSet()
                for i in range(len(boxes)):
                    obs.add(pkg.VisualSortObservation(
                        feat[i] if fvalid[i] else None, float(qual[i]),
                        pkg.Universal2DBox.from_vec5(boxes[i],
                                                     float(conf[i])), i))
                sets.append(obs)
            tj, tp = jt.predict(sets[0]), ptr.predict(sets[1])
            assert [(t.id, t.length, t.voting_type.name) for t in tp] == [
                (t.id, t.length, t.voting_type.name) for t in tj]
            continue
        oj = jt.predict_arrays(0, boxes, conf, feat, fvalid, qual, cids)
        op = ptr.predict_arrays(0, boxes, conf, feat, fvalid, qual, cids)
        _check_out(oj, op, s, exact)
        votes += int((op[5] == 0).sum())
    assert votes > 0
    st = ptr._scenes[0].state
    assert isinstance(st.feats, np.ndarray) and st.feature_dim == 12
    assert st.capacity == jt._scenes[0].state.capacity > 16
    _check_state(jt, ptr, exact)
    waste = _check_waste(jt, ptr)
    assert any(f is not None for w in waste for f in w.observed_features)


def _flipped(boxes, s, at=6):
    """Aligned boxes before call `at`, rotated from it on (the store's
    oriented flip)."""
    if s >= at:
        boxes = boxes.copy()
        boxes[:, 2] = 0.3
    return boxes


@pytest.mark.parametrize("kind", ["sort", "visual"])
def test_sessions_survive_grow_flip_and_checkpoint_load(kind, tmp_path):
    """A host store's native session is rebuilt wherever its leaves are
    replaced: the capacity grows from 8 (and the feature dimension, for
    VisualSort), the boxes turn oriented at call 6, a checkpoint loads
    into the running tracker at call 11 (no grow follows) and into a
    fresh one at call 14.  The ids, slots and lengths equal those of a
    tracker that ran uninterrupted, call for call, and every session runs
    its store's oriented flag."""
    from similari_tpu_torch.utils import load_tracker, save_tracker

    if kind == "sort":
        def make():
            return pt.Sort(shards=1, bbox_history=2, max_idle_epochs=3,
                           method=pt.PositionalMetricType.iou(0.3),
                           initial_capacity=8, engine="host", device="cpu")
        calls = [(b, c) for b, c in churn_stream(
            7, steps=18, n=14, spread=400.0, churn=4)]
    else:
        def make():
            return pt.VisualSort(1, _visual_opts(pt), initial_capacity=8,
                                 engine="host", device="cpu")
        calls = _visual_frames(7, steps=18, n=14, f=8, grow_at=8)
    whole, resumed = make(), make()
    for s, (boxes, *rest) in enumerate(calls):
        if s in (11, 14):
            path = tmp_path / f"ckpt_{s}.npz"
            save_tracker(resumed, path)
            assert resumed._scenes[0].session is not None
            resumed = load_tracker(resumed if s == 11 else make(), path)
        boxes = _flipped(boxes, s)
        ow = whole.predict_arrays(0, boxes, *rest)
        orr = resumed.predict_arrays(0, boxes, *rest)
        for i in (1, 3, 4):  # ids, lengths, slots
            np.testing.assert_array_equal(orr[i], ow[i], err_msg=f"{i} {s}")
        for tr in (whole, resumed):
            store = tr._scenes[0]
            assert store.session.cfg.oriented == store.oriented, s
    for tr in (whole, resumed):
        store = tr._scenes[0]
        assert store.oriented and store.session is not None
        assert store.state.capacity >= 32
    assert whole._next_track_id == resumed._next_track_id > 20


def test_bf16_visual_sort_under_host_runs_the_device_step():
    """A bf16 gallery is a device storage type: under "host" both packages
    run their device step (the JAX package's with feature_precision bf16),
    and the ids agree."""
    jt = jx.VisualSort(1, _visual_opts(jx), initial_capacity=16,
                       engine="host")
    jt._cfg = dataclasses.replace(jt._cfg, feature_precision="bf16")
    ptr = pt.VisualSort(1, _visual_opts(pt).feature_precision("bf16"),
                        initial_capacity=16, engine="host", device="cpu")
    for s, (boxes, conf, feat, fvalid, qual) in enumerate(_visual_frames(
            2, steps=6, n=10, f=8)):
        oj = jt.predict_arrays(0, boxes, conf, feat, fvalid, qual)
        op = ptr.predict_arrays(0, boxes, conf, feat, fvalid, qual)
        _check_out(oj, op, s, exact=False)
    st = ptr._scenes[0].state
    assert not ptr._scenes[0].host and not jt._scenes[0].host
    assert isinstance(st.feats, torch.Tensor)
    assert st.feats.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

SCENES = (4, 11, 2)
ABSENT = {3: 11, 6: 2}


def _batch_streams(steps, n, f):
    out = {}
    for k, sid in enumerate(SCENES):
        rng = np.random.default_rng(80 + k)
        ident = rng.normal(size=(n, f)).astype(np.float32)
        frames = churn_stream(20 + k, steps, n, spread=300.0, churn=3)
        out[sid] = [(b, c, (ident + 0.05 * rng.normal(size=(n, f))).astype(
            np.float32)) for b, c in frames]
    return out


def _request(pkg, visual, streams, s):
    req = (pkg.VisualSortPredictionBatchRequest() if visual
           else pkg.SortPredictionBatchRequest())
    for sid in SCENES:
        if ABSENT.get(s) == sid:
            continue
        b, c, f = streams[sid][s]
        for i in range(len(b)):
            box = pkg.Universal2DBox.from_vec5(b[i], float(c[i]))
            if visual:
                req.add(sid, pkg.VisualSortObservation(f[i], 1.0, box, i))
            else:
                req.add(sid, box, i)
    return req


def _drain(res):
    out = {}
    while res.ready():
        sid, tracks = res.get()
        out[sid] = [(t.id, t.length, t.voting_type.name, t.custom_object_id)
                    for t in tracks]
    return out


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("visual", [False, True])
def test_batch_host_engines_match_jax(path, visual, monkeypatch):
    _path(path, monkeypatch)
    streams = _batch_streams(steps=10, n=8, f=6)
    if visual:
        def make(pkg, **extra):
            return pkg.BatchVisualSort(opts=_visual_opts(pkg),
                                       initial_capacity=8, engine="host",
                                       **extra)
    else:
        def make(pkg, **extra):
            return pkg.BatchSort(method=pkg.PositionalMetricType.iou(0.3),
                                 max_idle_epochs=2, initial_capacity=8,
                                 engine="host", **extra)
    jt, ptr = make(jx), make(pt, device="cpu")
    for s in range(10):
        assert _drain(ptr.predict(_request(pt, visual, streams, s))) == \
            _drain(jt.predict(_request(jx, visual, streams, s))), s
    assert ptr.shard_stats() == jt.shard_stats()
    for sid in SCENES:
        assert ptr.current_epoch_with_scene(sid) == \
            jt.current_epoch_with_scene(sid)
        assert [t.id for t in ptr.idle_tracks_with_scene(sid)] == [
            t.id for t in jt.idle_tracks_with_scene(sid)]
    ptr.skip_epochs_for_scene(4, 9)
    jt.skip_epochs_for_scene(4, 9)
    assert sorted(w.id for w in ptr.wasted()) == sorted(
        w.id for w in jt.wasted())


# --------------------------------------------------------------------------
# the interactive runners and the csv IO
# --------------------------------------------------------------------------

def _detections(seed, frames=(1, 2, 3, 5, 6, 9), n=9):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2))
    dets, feats = {}, {}
    ident = rng.normal(size=(n, 6))
    for f in frames:
        xy += rng.uniform(-3, 3, xy.shape)
        keep = rng.uniform(size=n) < 0.9
        dets[f] = [(float(x) - 12, float(y) - 20, 24.0, 40.0,
                    float(rng.uniform(0.5, 1)))
                   for (x, y), k in zip(xy, keep) if k]
        feats[f] = [list(ident[i] + 0.05 * rng.normal(size=6))
                    if i % 4 else None for i in np.flatnonzero(keep)]
    return dets, feats


@pytest.mark.parametrize("engine", ["host", "device"])
def test_interactive_runners_match_jax(engine):
    dets, feats = _detections(0)

    def sort(pkg, **extra):
        return pkg.Sort(1, method=pkg.PositionalMetricType.iou(0.3),
                        max_idle_epochs=2, **extra)

    out_j = jmot.run_sequence_interactive(sort(jx, engine="host"), dets)
    out_p = pmot.run_sequence_interactive(sort(pt, engine=engine,
                                               device="cpu"), dets)
    assert out_p.keys() == out_j.keys() == dets.keys()
    for f in out_j:
        assert [r[0] for r in out_p[f]] == [r[0] for r in out_j[f]], f
        np.testing.assert_allclose(np.array([r[1:] for r in out_p[f]]),
                                   np.array([r[1:] for r in out_j[f]]),
                                   rtol=API_RTOL, atol=API_ATOL)
    vj = jmot.run_sequence_interactive_visual(
        jx.VisualSort(1, _visual_opts(jx), engine="host"), dets, feats)
    vp = pmot.run_sequence_interactive_visual(
        pt.VisualSort(1, _visual_opts(pt), engine=engine, device="cpu"),
        dets, feats)
    assert vp == vj


def test_read_gt_write_csv_round_trip(tmp_path):
    rows = [(1, 3, 10.5, 20.0, 30.0, 40.25, 1, -1, -1, -1),
            (1, 4, 0.0, 1.0, 2.0, 3.0, 1, -1, -1, -1),
            (2, 3, 11.5, 21.0, 30.0, 40.25, 1, -1, -1, -1)]
    path = tmp_path / "gt.txt"
    pmot.write_csv(path, rows)
    jmot.write_csv(tmp_path / "jax.txt", rows)
    assert path.read_text() == (tmp_path / "jax.txt").read_text()
    want = {1: [(3, 10.5, 20.0, 30.0, 40.25), (4, 0.0, 1.0, 2.0, 3.0)],
            2: [(3, 11.5, 21.0, 30.0, 40.25)]}
    assert pmot.read_gt(path) == jmot.read_gt(path) == want
    assert pmot.read_detections(path) == jmot.read_detections(path)


@pytest.mark.parametrize("visual", [False, True])
def test_host_engine_first_call_without_detections(visual):
    """A store's first call holds no detection: the port's host engine
    returns an empty result, as the JAX package's device engine does (its
    host engine raises there), and the next call opens the same tracks."""
    f = 6
    if visual:
        def make(pkg, **kw):
            return pkg.VisualSort(1, _visual_opts(pkg), **kw)

        def call(tr, boxes, conf):
            n = len(boxes)
            feat = np.ones((n, f), np.float32) * np.arange(1, n + 1)[:, None]
            return tr.predict_arrays(0, boxes, conf, feat, np.ones(n, bool),
                                     np.ones(n, np.float32))
    else:
        def make(pkg, **kw):
            return pkg.Sort(1, method=pkg.PositionalMetricType.iou(0.3),
                            **kw)

        def call(tr, boxes, conf):
            return tr.predict_arrays(0, boxes, conf)

    jt = make(jx, engine="device")
    ptr = make(pt, engine="host", device="cpu")
    empty = (np.zeros((0, 5), np.float32), np.zeros((0,), np.float32))
    out_j, out_p = call(jt, *empty), call(ptr, *empty)
    assert len(out_p) == len(out_j) and out_p[0] == out_j[0]  # the epoch
    for a, b in zip(out_j[1:], out_p[1:]):
        assert np.asarray(b).shape == np.asarray(a).shape
        assert np.asarray(b).size == 0
    boxes = np.array([[10.0, 20.0, 0.0, 0.5, 40.0],
                      [200.0, 220.0, 0.0, 0.6, 30.0]], np.float32)
    conf = np.ones((2,), np.float32)
    out_j, out_p = call(jt, boxes, conf), call(ptr, boxes, conf)
    np.testing.assert_array_equal(np.asarray(out_p[1]), np.asarray(out_j[1]))
