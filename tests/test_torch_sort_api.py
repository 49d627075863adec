"""The port's `Sort` API against the JAX package's `Sort(engine="device")`,
on the CPU.

The same numpy streams go through both trackers' `predict_arrays` (or
`predict` on box objects): ids, slots and lengths must be equal, predicted
boxes within tests/test_host_sort.py's rtol 2e-4 / atol 1e-3.  Capacity
starts at 16 and grows; the streams churn, carry oriented boxes,
constraints and custom ids, and end with idle tracks and the waste.
"""

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan
from similari_tpu_torch.trackers.state import new_sort_state

from torch_parity import API_ATOL, API_RTOL, churn_stream, one_cpu_thread

one_cpu_thread()


def _method(pkg, kind):
    return (pkg.PositionalMetricType.iou(0.3) if kind == "iou"
            else pkg.PositionalMetricType.maha())


def _pair(kind="iou", constraints=(), **kw):
    """(JAX tracker, port tracker) of one configuration."""
    def make(pkg, **extra):
        stc = pkg.SpatioTemporalConstraints()
        if constraints:
            stc.add_constraints(list(constraints))
        return pkg.Sort(shards=1, bbox_history=2, max_idle_epochs=3,
                        method=_method(pkg, kind),
                        spatio_temporal_constraints=stc,
                        initial_capacity=16, **kw, **extra)

    return make(jx, engine="device"), make(pt, device="cpu")


def _assert_frame(out_j, out_p, s):
    _, ids_j, pred_j, len_j, slot_j = out_j
    epoch, ids_p, pred_p, len_p, slot_p = out_p
    assert epoch == out_j[0]
    np.testing.assert_array_equal(ids_p, ids_j, err_msg=f"ids frame {s}")
    np.testing.assert_array_equal(slot_p, slot_j, err_msg=f"slots frame {s}")
    np.testing.assert_array_equal(len_p, len_j, err_msg=f"lengths frame {s}")
    np.testing.assert_allclose(pred_p, pred_j, rtol=API_RTOL, atol=API_ATOL,
                               err_msg=f"pred frame {s}")


def _run_both(jt, ptr, frames, customs=None):
    for s, (boxes, conf) in enumerate(frames):
        cids = None if customs is None else customs(s, len(boxes))
        _assert_frame(jt.predict_arrays(0, boxes, conf, cids),
                      ptr.predict_arrays(0, boxes, conf, cids), s)


@pytest.mark.parametrize("kind", ["iou", "maha"])
def test_churn_stream_with_growth_matches_jax(kind):
    jt, ptr = _pair(kind)
    frames = churn_stream(0, steps=10, n=12, spread=400.0, churn=3)
    _run_both(jt, ptr, frames)
    assert ptr._scenes[0].state.capacity == jt._scenes[0].state.capacity > 16
    assert ptr.shard_stats() == jt.shard_stats()


def test_oriented_stream_matches_jax():
    """Rotated boxes flip the scene's sticky oriented flag."""
    jt, ptr = _pair("iou")
    aligned = churn_stream(1, steps=3, n=10, spread=300.0)
    rotated = churn_stream(1, steps=6, n=10, spread=300.0, angle=0.6)[3:]
    _run_both(jt, ptr, aligned + rotated)
    assert ptr._scenes[0].oriented and jt._scenes[0].oriented


def test_constraints_and_custom_ids_match_jax():
    jt, ptr = _pair("iou", constraints=((1, 1.0), (3, 2.0)))
    frames = churn_stream(3, steps=8, n=10, spread=300.0, churn=3)
    _run_both(jt, ptr, frames,
              customs=lambda s, n: [None if i % 3 == 0 else 100 * s + i
                                    for i in range(n)])
    idle_j = jt.idle_tracks()
    idle_p = ptr.idle_tracks()
    key = lambda t: (t.id, t.epoch, t.length, t.custom_object_id)  # noqa: E731
    assert sorted(map(key, idle_p)) == sorted(map(key, idle_j))
    assert idle_p and all(t.voting_type == pt.VotingType.Positional
                          for t in idle_p)


def _wasted_key(w):
    return (w.id, w.epoch, w.scene_id, w.length, len(w.observed_boxes),
            tuple(b.xc for b in w.observed_boxes))


def test_predict_objects_idle_and_waste_match_jax():
    """`predict` on Universal2DBox objects in two scenes, then
    `skip_epochs` and `wasted()`, then `set_auto_waste`."""
    jt, ptr = _pair("iou")
    frames = churn_stream(4, steps=6, n=8, spread=300.0, churn=2)
    for s, (boxes, conf) in enumerate(frames):
        for scene in (0, 7):
            def dets(pkg):
                return [(pkg.Universal2DBox.new_with_confidence(
                    *(float(v) for v in b[:2]), None, *(float(v) for v in b[3:]),
                    float(c)), i if i % 2 else None)
                    for i, (b, c) in enumerate(zip(boxes, conf))]
            tj = jt.predict_with_scene(scene, dets(jx))
            tp = ptr.predict_with_scene(scene, dets(pt))
            assert [(t.id, t.length, t.epoch, t.scene_id, t.custom_object_id)
                    for t in tp] == [(t.id, t.length, t.epoch, t.scene_id,
                                      t.custom_object_id) for t in tj]
            for a, b in zip(tp, tj):
                np.testing.assert_allclose(
                    a.predicted_bbox.to_vec5(), b.predicted_bbox.to_vec5(),
                    rtol=API_RTOL, atol=API_ATOL)
                assert a.observed_bbox == b.observed_bbox
    assert ptr.predict([]) == [] and jt.predict([]) == []
    assert ptr.current_epoch_with_scene(7) == jt.current_epoch_with_scene(7)
    # churned objects went idle; skipping epochs wastes every track of
    # scene 0 once
    jt.skip_epochs(4)
    ptr.skip_epochs(4)
    wj, wp = jt.wasted(), ptr.wasted()
    assert sorted(map(_wasted_key, wp)) == sorted(map(_wasted_key, wj))
    assert len({w.id for w in wp}) == len(wp) > 0
    assert ptr.wasted() == [] and ptr.wasted_shard_stats() == [0]
    assert ptr.shard_stats() == jt.shard_stats()
    # a new periodicity triggers on the next predict: scene 7's idle tracks
    for tr in (jt, ptr):
        tr.skip_epochs_for_scene(7, 0)
        tr.clear_wasted()
        tr._epochs[7] += 10
        tr.set_auto_waste(5)
    boxes, conf = frames[-1]
    jt.predict_arrays(0, boxes, conf)
    ptr.predict_arrays(0, boxes, conf)
    assert ptr.wasted_shard_stats() == jt.wasted_shard_stats()
    wj, wp = jt.wasted(), ptr.wasted()
    assert {w.scene_id for w in wp} == {7}
    assert sorted(map(_wasted_key, wp)) == sorted(map(_wasted_key, wj))


def test_api_ids_equal_a_fixed_capacity_scan():
    """Growth from 16 slots leaves ids, slots and lengths as a scan at a
    fixed large capacity gives them (`nth_free_slot` takes the lowest free
    slot)."""
    frames = churn_stream(5, steps=12, n=12, spread=400.0, churn=3)
    ptr = pt.Sort(bbox_history=2, max_idle_epochs=3,
                  method=pt.PositionalMetricType.iou(0.3),
                  initial_capacity=16, device="cpu")
    api = [ptr.predict_arrays(0, b, c) for b, c in frames]
    assert ptr._scenes[0].state.capacity == 64
    cfg = SortConfig(method="iou", max_idle_epochs=3, oriented=False)
    box = torch.as_tensor(np.stack([b for b, _ in frames]))
    conf = torch.as_tensor(np.stack([c for _, c in frames]))
    _, out = sort_scan(cfg, new_sort_state(256, 2, device="cpu"), box, conf,
                       torch.ones(conf.shape, dtype=torch.bool), 1)
    for s, (_, ids, pred, length, slot) in enumerate(api):
        np.testing.assert_array_equal(ids, out.track_id[s].numpy())
        np.testing.assert_array_equal(slot, out.slot[s].numpy())
        np.testing.assert_array_equal(length, out.length[s].numpy())


def test_engine_rule():
    """"host" runs the NumPy step on numpy leaves; "auto" and "device" keep
    the state on the tracker's device; unknown engines raise."""
    with pytest.raises(ValueError, match="engine"):
        pt.Sort(engine="xla", device="cpu")
    assert pt.Sort(engine="device", device="cpu").device.type == "cpu"
    boxes, conf = churn_stream(0, steps=1, n=4)[0]
    ids = {}
    for engine in ("host", "auto", "device"):
        tr = pt.Sort(engine=engine, device="cpu")
        ids[engine] = tr.predict_arrays(0, boxes, conf)[1]
        leaf = tr._scenes[0].state.active
        assert isinstance(leaf, np.ndarray if engine == "host"
                          else torch.Tensor), engine
    np.testing.assert_array_equal(ids["host"], ids["device"])
    np.testing.assert_array_equal(ids["auto"], ids["device"])


def test_sort_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.Sort()


def test_overflow_raises():
    """The step's overflow flag reaches the caller as the JAX API's
    RuntimeError (here a state too small for a frame, as growth never
    allows)."""
    ptr = pt.Sort(method=pt.PositionalMetricType.iou(0.3), device="cpu",
                  initial_capacity=8)
    store = ptr._get_store(0)
    store.grow = lambda n: None
    boxes, conf = churn_stream(6, steps=1, n=12)[0]
    with pytest.raises(RuntimeError, match="overflow"):
        ptr.predict_arrays(0, boxes, conf)
