"""The port's tracker checkpoints (`utils/checkpoint.py`) against the JAX
package's file format.

`Sort` (aligned and oriented) and `VisualSort` (f32 and bf16 galleries)
on both of the port's engines save mid-stream and load into a fresh
tracker: the port into the port, a JAX `save_tracker` file into the port,
and a port file into the JAX package.  After the load both trackers go on
with the stream and must give equal ids, lengths and slots every frame,
through capacity growth before the save.  Also tests/test_checkpoint.py's
oriented flag and the reset of a tracker that had stepped before the
load.
"""

import dataclasses

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu.utils import checkpoint as jckpt
from similari_tpu_torch.utils import checkpoint as pckpt

from torch_parity import churn_stream, one_cpu_thread

one_cpu_thread()

N, F, STEPS, SAVE_AT = 7, 8, 10, 5
KINDS = ("sort_aligned", "sort_oriented", "visual_f32", "visual_bf16")
ENGINES = ("device", "host")


def _frames(kind):
    """churn_stream's boxes (fixed angles for the oriented case) with
    per-object features and qualities for the visual trackers."""
    angle = 0.6 if kind == "sort_oriented" else 0.0
    frames = churn_stream(3, STEPS, N, spread=400.0, churn=3, angle=angle)
    rng = np.random.default_rng(8)
    ident = rng.normal(size=(64, F)).astype(np.float32)
    out = []
    for s, (boxes, conf) in enumerate(frames):
        feat = ident[(np.arange(N) + 3 * (s // 3)) % 64] + 0.05 * \
            rng.normal(size=(N, F)).astype(np.float32)
        out.append((boxes, conf, feat.astype(np.float32),
                    np.ones(N, bool), rng.uniform(0.3, 1, N).astype(
                        np.float32)))
    return out


def _opts(pkg):
    return (pkg.VisualSortOptions()
            .visual_metric(pkg.VisualSortMetricType.euclidean(5.0))
            .positional_metric(pkg.PositionalMetricType.iou(0.3))
            .visual_minimal_track_length(2).visual_max_observations(3)
            .max_idle_epochs(3).kept_history_length(2))


def _port(kind, engine):
    if kind.startswith("sort"):
        return pt.Sort(1, bbox_history=2, max_idle_epochs=3,
                       method=pt.PositionalMetricType.iou(0.3),
                       initial_capacity=4, engine=engine, device="cpu")
    opts = _opts(pt).feature_precision(kind[len("visual_"):])
    return pt.VisualSort(1, opts, initial_capacity=4, engine=engine,
                         device="cpu")


def _jax(kind):
    if kind.startswith("sort"):
        return jx.Sort(1, bbox_history=2, max_idle_epochs=3,
                       method=jx.PositionalMetricType.iou(0.3),
                       initial_capacity=4, engine="device")
    t = jx.VisualSort(1, _opts(jx), initial_capacity=4, engine="device")
    t._cfg = dataclasses.replace(t._cfg,
                                 feature_precision=kind[len("visual_"):])
    return t


def _step(tracker, kind, frame):
    """(ids, lengths, slots) of one predict_arrays call."""
    boxes, conf, feat, fvalid, qual = frame
    if kind.startswith("sort"):
        _, ids, _, length, slot = tracker.predict_arrays(0, boxes, conf)
    else:
        _, ids, _, length, slot, _ = tracker.predict_arrays(
            0, boxes, conf, feat, fvalid, qual)
    return [np.asarray(a) for a in (ids, length, slot)]


def _resume_and_compare(kind, a, b, frames):
    """Both trackers on the rest of the stream: equal every frame."""
    for s in range(SAVE_AT, STEPS):
        for name, x, y in zip(("ids", "lengths", "slots"),
                              _step(a, kind, frames[s]),
                              _step(b, kind, frames[s])):
            np.testing.assert_array_equal(y, x, err_msg=f"{name} frame {s}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_port_round_trip(tmp_path, kind, engine):
    frames = _frames(kind)
    a = _port(kind, engine)
    for s in range(SAVE_AT):
        _step(a, kind, frames[s])
    assert a._scenes[0].state.capacity > 4  # grown before the save
    path = tmp_path / "ckpt.npz"
    pckpt.save_tracker(a, path)
    b = pckpt.load_tracker(_port(kind, engine), path)
    assert b.current_epoch() == SAVE_AT
    st = b._scenes[0].state
    if kind.startswith("visual"):
        assert b._feature_dim == F
        want = torch.bfloat16 if kind.endswith("bf16") else torch.float32
        if b._scenes[0].host:
            assert st.feats.dtype == np.float32
        else:
            assert st.feats.dtype == want
    assert isinstance(st.active, np.ndarray) == b._scenes[0].host
    _resume_and_compare(kind, a, b, frames)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_into_the_port(tmp_path, kind, engine):
    frames = _frames(kind)
    j = _jax(kind)
    for s in range(SAVE_AT):
        _step(j, kind, frames[s])
    path = tmp_path / "jax.npz"
    jckpt.save_tracker(j, path)
    p = pckpt.load_tracker(_port(kind, engine), path)
    assert p._scenes[0].oriented == (kind == "sort_oriented")
    _resume_and_compare(kind, j, p, frames)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_into_jax(tmp_path, kind, engine):
    frames = _frames(kind)
    p = _port(kind, engine)
    for s in range(SAVE_AT):
        _step(p, kind, frames[s])
    path = tmp_path / "port.npz"
    pckpt.save_tracker(p, path)
    with np.load(path) as data:  # plain numpy types only
        assert all(data[k].dtype.kind in "biuf" for k in data.files)
    j = jckpt.load_tracker(_jax(kind), path)
    _resume_and_compare(kind, p, j, frames)


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_keeps_the_oriented_flag_and_resets_the_store(
        tmp_path, engine):
    """tests/test_checkpoint.py's case: the sticky rotated-box flag
    survives, and a tracker that stepped another scene before the load
    takes the loaded state in its engine's form."""
    t1 = _port("sort_aligned", engine)
    rot = np.array([[50.0, 50, 0.6, 1.0, 20]], np.float32)
    conf = np.ones((1,), np.float32)
    _, ids0, _, _, _ = t1.predict_arrays(0, rot, conf)
    assert t1._scenes[0].oriented
    path = tmp_path / "oriented.npz"
    pckpt.save_tracker(t1, path)

    t2 = _port("sort_aligned", engine)
    t2.predict_arrays(1, np.array([[5.0, 5, 0, 1, 10]], np.float32), conf)
    t2.predict_arrays(0, np.array([[900.0, 5, 0, 1, 10]], np.float32),
                      conf)
    before = t2._scenes[0].state
    pckpt.load_tracker(t2, path)
    store = t2._scenes[0]
    assert store.oriented and store.state is not before
    assert store.host == (engine == "host")
    assert isinstance(store.state.active, np.ndarray) == store.host
    rot2 = rot.copy()
    rot2[0, 0] += 1
    _, ids1, _, _, _ = t2.predict_arrays(0, rot2, conf)
    np.testing.assert_array_equal(ids1, ids0)
    assert t2._scenes[1].active_count == 1  # a scene not in the file stays
