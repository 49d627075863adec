"""The port's `VisualSort` API against the JAX package's
`VisualSort(engine="device")`, on the CPU.

The same numpy streams go through both trackers: ids, slots, lengths and
voting types must be equal, predicted boxes within rtol 2e-4 / atol 1e-3
(tests/test_host_sort.py's).  The streams miss features on some rows,
grow the feature dimension and the capacity (from 16), run f32 and bf16
galleries, and gate on own areas computed by the f64 clipping oracle
("host") or inside the step ("device").  The JAX tracker's bf16 is its
step's `feature_precision="bf16"` over an f32 store: the port keeps the
store itself in bf16, whose values are the same bf16-rounded features.
"""

import dataclasses

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt

from torch_parity import API_ATOL, API_RTOL, churn_stream, one_cpu_thread

one_cpu_thread()


def _frames(seed, steps, n, f, spread=300.0, churn=3, angle=0.0,
            grow_at=None):
    """churn_stream's boxes with per-object identities plus noise;
    ~15% of rows without a feature, qualities U(0.3, 1).  From frame
    `grow_at` on the features are 4 wider."""
    rng = np.random.default_rng(seed + 50)
    ident = rng.normal(size=(n, f + 4)).astype(np.float32)
    out = []
    for s, (boxes, conf) in enumerate(churn_stream(
            seed, steps, n, spread=spread, churn=churn, angle=angle)):
        width = f + 4 if grow_at is not None and s >= grow_at else f
        feat = (ident[:, :width] + 0.05 * rng.normal(size=(n, width))
                ).astype(np.float32)
        fvalid = rng.uniform(size=n) < 0.85
        qual = rng.uniform(0.3, 1.0, n).astype(np.float32)
        out.append((boxes, conf, feat, fvalid, qual))
    return out


def _opts(pkg, metric=("euclidean", 5.0), positional="iou", history=2,
          own_area=None, min_len=2):
    o = (pkg.VisualSortOptions()
         .visual_metric(getattr(pkg.VisualSortMetricType, metric[0])(
             metric[1]))
         .positional_metric(pkg.PositionalMetricType.iou(0.3)
                            if positional == "iou"
                            else pkg.PositionalMetricType.maha())
         .visual_minimal_track_length(min_len)
         .visual_max_observations(3)
         .max_idle_epochs(3)
         .kept_history_length(history))
    if own_area is not None:
        o = (o.visual_minimal_own_area_percentage_use(0.6)
             .visual_minimal_own_area_percentage_collect(0.6)
             .own_area_backend(own_area))
    return o


def _pair(precision="f32", **kw):
    jt = jx.VisualSort(1, _opts(jx, **kw), initial_capacity=16,
                       engine="device")
    jt._cfg = dataclasses.replace(jt._cfg, feature_precision=precision)
    ptr = pt.VisualSort(1, _opts(pt, **kw).feature_precision(precision),
                        initial_capacity=16, device="cpu")
    return jt, ptr


def _assert_frame(oj, op, s):
    assert oj[0] == op[0]
    for name, a, b in zip(("ids", "pred", "lengths", "slots", "voting"),
                          op[1:], oj[1:]):
        if name == "pred":
            np.testing.assert_allclose(a, b, rtol=API_RTOL, atol=API_ATOL,
                                       err_msg=f"pred frame {s}")
        else:
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"{name} frame {s}")


def _run_arrays(jt, ptr, frames):
    votes = 0
    for s, (boxes, conf, feat, fvalid, qual) in enumerate(frames):
        cids = list(range(len(boxes)))
        oj = jt.predict_arrays(0, boxes, conf, feat, fvalid, qual, cids)
        op = ptr.predict_arrays(0, boxes, conf, feat, fvalid, qual, cids)
        _assert_frame(oj, op, s)
        votes += int((op[5] == 0).sum())
    return votes


CONFIGS = {
    "euclid_f32": dict(),
    "euclid_bf16": dict(precision="bf16"),
    "cosine_maha_bf16": dict(precision="bf16", metric=("cosine", 0.8),
                             positional="maha"),
    "oriented_history3": dict(history=3),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_arrays_match_jax(name):
    kw = dict(CONFIGS[name])
    angle = 0.6 if name.startswith("oriented") else 0.0
    jt, ptr = _pair(**kw)
    frames = _frames(0, steps=9, n=10, f=8, angle=angle, grow_at=5)
    votes = _run_arrays(jt, ptr, frames)
    assert votes > 0  # the gallery path ran
    st = ptr._scenes[0].state
    assert st.capacity == jt._scenes[0].state.capacity > 16
    assert st.feature_dim == jt._scenes[0].state.feature_dim == 12
    want = torch.bfloat16 if kw.get("precision") == "bf16" else torch.float32
    assert st.feats.dtype == st.hist_feat.dtype == want


def _gating_boxes(step):
    # two heavily-overlapping boxes, whose own-area shares (~0.2) fail the
    # 0.6 use/collect gates, and a free one
    b = np.array([[50.0, 50.0, 0.0, 1.0, 40.0], [58.0, 50.0, 0.0, 1.0, 40.0],
                  [120.0, 50.0, 0.0, 1.0, 40.0]], np.float32)
    b[:, 0] += step
    return b


@pytest.mark.parametrize("backend", ["host", "device"])
def test_own_area_gates_match_jax(backend):
    """tests/test_visual_gating.py's case: objects and arrays, one gated
    box; the shares reach the step on the host backend too."""
    feats = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    kw = dict(own_area=backend, min_len=1)
    jt, ptr = _pair(**kw)
    ja, pa = _pair(**kw)
    for step in range(4):
        b = _gating_boxes(step)

        def obs(pkg):
            o = pkg.VisualSortObservationSet()
            for i in range(3):
                o.add(pkg.VisualSortObservation(
                    feats[i], 0.9, pkg.Universal2DBox.from_vec5(b[i], 0.9),
                    i))
            return o

        tj = jt.predict_with_scene(0, obs(jx))
        tp = ptr.predict_with_scene(0, obs(pt))
        assert [(t.id, t.voting_type.name, t.length, t.custom_object_id)
                for t in tp] == [(t.id, t.voting_type.name, t.length,
                                  t.custom_object_id) for t in tj]
        args = (b, np.full((3,), 0.9, np.float32), feats, np.ones((3,), bool),
                np.full((3,), 0.9, np.float32))
        _assert_frame(ja.predict_arrays(0, *args), pa.predict_arrays(0, *args),
                      step)
        # the two overlapping boxes own ~20% of their area and never vote
        # visually; the free one does once its track has a feature
        vt = [t.voting_type.name for t in tp]
        assert vt[:2] == ["Positional"] * 2
        assert vt[2] == ("Visual" if step else "Positional")


def test_missing_features_idle_and_waste_match_jax():
    jt, ptr = _pair(history=3)
    frames = _frames(2, steps=7, n=8, f=6)
    for s, (boxes, conf, feat, fvalid, qual) in enumerate(frames):
        if s == 3:  # a frame without any feature
            feat, fvalid = None, None
        _assert_frame(jt.predict_arrays(5, boxes, conf, feat, fvalid, qual),
                      ptr.predict_arrays(5, boxes, conf, feat, fvalid, qual),
                      s)
    key = lambda t: (t.id, t.epoch, t.length, t.voting_type.name)  # noqa: E731
    assert sorted(map(key, ptr.idle_tracks_with_scene(5))) == sorted(
        map(key, jt.idle_tracks_with_scene(5)))
    jt.skip_epochs_for_scene(5, 5)
    ptr.skip_epochs_for_scene(5, 5)
    wj = {w.id: w for w in jt.wasted()}
    wp = {w.id: w for w in ptr.wasted()}
    assert wp.keys() == wj.keys() and wp
    for i, w in wp.items():
        assert (w.epoch, w.length, w.scene_id) == (wj[i].epoch, wj[i].length,
                                                   wj[i].scene_id)
        assert [f is None for f in w.observed_features] == [
            f is None for f in wj[i].observed_features]
        for a, b in zip(w.observed_features, wj[i].observed_features):
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert ptr.shard_stats() == jt.shard_stats() == [0]


def test_engine_rule_and_device():
    """"host" runs the NumPy step for f32 galleries (numpy leaves) and the
    device step for bf16 ones; unknown engines raise."""
    with pytest.raises(ValueError, match="engine"):
        pt.VisualSort(engine="xla", device="cpu")
    assert pt.VisualSort(engine="auto", device="cpu").device.type == "cpu"
    box = np.array([[10.0, 10.0, 0.0, 0.5, 20.0]], np.float32)
    one = np.ones((1,), np.float32)
    for precision, host in (("f32", True), ("bf16", False)):
        tr = pt.VisualSort(opts=pt.VisualSortOptions().feature_precision(
            precision), engine="host", device="cpu")
        _, ids, *_ = tr.predict_arrays(0, box, one, one[:, None])
        assert ids.tolist() == [1]
        leaf = tr._scenes[0].state.feats
        assert isinstance(leaf, np.ndarray) == host, precision


def test_visual_sort_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.VisualSort()
