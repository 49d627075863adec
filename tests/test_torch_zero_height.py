"""Valid zero-height detections, on the CPU: the port against the JAX
package's host engines and its Pallas runners.

A valid detection of height 0 opens a track whose Kalman state turns NaN.
A Mahalanobis weight against such a track passes the distance gates, so
the voting matrix holds NaN.  The port treats a NaN weight as no edge
before any solver sees it (`ops/assignment.py::edges`), as the reference's
host engine does (its `w > 0` edge test is false for NaN), so every
assignment backend ("auction", "hungarian", "native") gives the host
engine's ids.

The oracle is the JAX package's host engine (`engine="host"`) for the
general steps and its Pallas runners (`engine="pallas"`, interpret mode on
the CPU) for the fused runners, never its XLA step: that step writes
state with a one-hot matmul (`similari_tpu/ops/merge.py`), which smears a
used row's NaN over every slot as 0 x NaN, so after one zero-height
detection it gives every other object new ids.  The port's gather merges
keep them.
"""

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu.eval import generate_sequence
from similari_tpu.eval import mot as jmot
from similari_tpu_torch.eval import mot as pmot
from similari_tpu_torch.ops import assignment as asg

from torch_parity import churn_stream, one_cpu_thread

one_cpu_thread()

BACKENDS = ("auction", "hungarian", "native")
ZERO_SHARE = 0.1  # share of valid detections whose height is 0


def _zero_frames(seed, steps=14, n=10, f=0):
    """churn_stream frames with a share of heights set to 0, plus features
    (identity + noise) when f > 0."""
    rng = np.random.default_rng(seed + 77)
    ident = rng.normal(size=(n, max(f, 1))).astype(np.float32)
    out = []
    for boxes, conf in churn_stream(seed, steps, n, spread=400.0, churn=4):
        boxes = boxes.copy()
        boxes[rng.random(n) < ZERO_SHARE, 4] = 0.0
        feat = (ident + 0.05 * rng.normal(size=ident.shape)).astype(np.float32)
        out.append((boxes, conf, feat[:, :f]))
    return out


def _zero_dets(dets, seed):
    """A MOT detections dict with a share of heights set to 0."""
    rng = np.random.default_rng(seed)
    return {f: [r[:3] + (0.0,) + r[4:] if rng.random() < ZERO_SHARE else r
                for r in rows] for f, rows in dets.items()}


def _ids(out):
    return {f: [r[0] for r in rows] for f, rows in out.items()}


def _has_zero_height(frames):
    return any((b[:, 4] == 0).any() for b, *_ in frames)


def test_first_argmax_never_returns_out_of_range():
    """NaN ranks below every number, so a row holding NaN keeps its first
    true max, and a row of NaN gives index 0, never n."""
    nan = float("nan")
    v = torch.tensor([[nan, 2.0, 5.0, 5.0], [1.0, nan, nan, 0.5],
                      [nan, nan, nan, nan], [3.0, 3.0, 1.0, nan]])
    m, i = asg.first_argmax(v, 1)
    assert i.tolist() == [2, 0, 0, 0]
    assert m[:2].tolist() == [5.0, 1.0] and m[2] == -torch.inf
    m0, i0 = asg.first_argmax(v, 0)
    assert i0.tolist() == [3, 3, 0, 0]
    ints = torch.tensor([[0, 1, 1], [0, 0, 0]], dtype=torch.int32)
    assert asg.first_argmax(ints, -1)[1].tolist() == [1, 0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_solvers_take_nan_as_no_edge(backend):
    """A NaN weight is no edge: the matrix with NaN solves like the one
    with 0 in its place, on every backend."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.uniform(0.2, 1.0, (6, 5)).astype(np.float32))
    w_nan = w.clone()
    w_nan[1, 2] = w_nan[3, :] = w_nan[:, 4] = float("nan")
    w_zero = torch.nan_to_num(w_nan, nan=0.0)
    rows = torch.ones(6, dtype=torch.bool)
    cols = torch.ones(5, dtype=torch.bool)
    a = asg.solve_voting(w_nan, 0.3, rows, cols, backend)
    b = asg.solve_voting(w_zero, 0.3, rows, cols, backend)
    assert a.tolist() == b.tolist()
    assert int(a[3]) == 3  # the all-NaN row opens a new track


def _sort(pkg, **kw):
    return pkg.Sort(shards=1, bbox_history=2, max_idle_epochs=3,
                    method=pkg.PositionalMetricType.maha(),
                    initial_capacity=16, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_maha_matches_host_engine(backend, seed):
    frames = _zero_frames(seed)
    assert _has_zero_height(frames)
    jt = _sort(jx, engine="host")
    ptr = _sort(pt, device="cpu", assignment_backend=backend)
    for s, (boxes, conf, _) in enumerate(frames):
        ids_j = jt.predict_arrays(0, boxes, conf)[1]
        ids_p = ptr.predict_arrays(0, boxes, conf)[1]
        np.testing.assert_array_equal(ids_p, ids_j, err_msg=f"frame {s}")
    # the stream did reach the NaN state the fix is about
    kf = ptr._scenes[0].state.kf
    assert any(torch.isnan(getattr(kf, n)).any()
               for n in ("mean_pos", "mean_vel", "cpp", "cpv", "cvv"))


def _box(pkg, row, conf):
    return pkg.Universal2DBox.new_with_confidence(
        float(row[0]), float(row[1]), None, float(row[3]), float(row[4]),
        float(conf))


def _first_seen(frames):
    """Ids renumbered by first appearance: the batched device engine
    reserves ids per scene in blocks, the host engine one by one, so
    the two number the same tracks differently (with finite inputs too)."""
    seen = {}
    return [[seen.setdefault(i, len(seen)) for i in ids] for ids in frames]


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_sort_maha_matches_host_engine(backend):
    scenes = {3: _zero_frames(2), 8: _zero_frames(3)}

    def make(pkg, **kw):
        return pkg.BatchSort(bbox_history=2, max_idle_epochs=3,
                             method=pkg.PositionalMetricType.maha(),
                             initial_capacity=16, **kw)

    trackers = ((jx, make(jx, engine="host")),
                (pt, make(pt, device="cpu", assignment_backend=backend)))
    ids = [{sid: [] for sid in scenes} for _ in trackers]
    for s in range(len(scenes[3])):
        for k, (pkg, tr) in enumerate(trackers):
            req = pkg.SortPredictionBatchRequest()
            for sid, frames in scenes.items():
                boxes, conf, _ = frames[s]
                for i in range(len(boxes)):
                    req.add(sid, _box(pkg, boxes[i], conf[i]), None)
            r = tr.predict(req)
            while r.ready():
                sid, tracks = r.get()
                ids[k][sid].append([t.id for t in tracks])
    for sid in scenes:
        assert _first_seen(ids[1][sid]) == _first_seen(ids[0][sid]), sid


def _visual_opts(pkg):
    return (pkg.VisualSortOptions()
            .visual_metric(pkg.VisualSortMetricType.euclidean(5.0))
            .positional_metric(pkg.PositionalMetricType.maha())
            .visual_minimal_track_length(2)
            .visual_max_observations(3)
            .max_idle_epochs(3)
            .kept_history_length(2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_visual_sort_maha_matches_host_engine(backend):
    frames = _zero_frames(4, f=8)
    jt = jx.VisualSort(1, _visual_opts(jx), initial_capacity=16,
                       engine="host")
    ptr = pt.VisualSort(1, _visual_opts(pt), initial_capacity=16,
                        assignment_backend=backend, device="cpu")
    for s, (boxes, conf, feat) in enumerate(frames):
        fv = np.arange(len(boxes)) % 3 != 0  # some rows vote positionally
        oj = jt.predict_arrays(0, boxes, conf, feat, fv)
        op = ptr.predict_arrays(0, boxes, conf, feat, fv)
        np.testing.assert_array_equal(op[1], oj[1], err_msg=f"ids {s}")
        np.testing.assert_array_equal(op[5], oj[5], err_msg=f"voting {s}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["iou", "maha"])
def test_step_runner_matches_host_engine(method, backend):
    """`run_sequence_device(engine="step")` against the JAX host `Sort`
    through its interactive runner, frame for frame."""
    _, dets = generate_sequence(n_objects=10, n_frames=30, seed=1,
                                p_miss=0.1, fp_per_frame=0.3)
    dz = _zero_dets(dets, 1)
    m = (jx.PositionalMetricType.iou(0.3) if method == "iou"
         else jx.PositionalMetricType.maha())
    ref = jmot.run_sequence_interactive(
        jx.Sort(shards=1, bbox_history=1, max_idle_epochs=5, method=m,
                engine="host"), dz)
    got, _ = pmot.run_sequence_device(dz, method=method, capacity=64,
                                      engine="step", assignment=backend,
                                      device="cpu")
    assert _ids(got) == _ids(ref)


@pytest.mark.parametrize("seed", [0, 2])
def test_fused_sort_runner_matches_pallas(seed):
    """The fused SORT runner's plain version against JAX's Pallas runner:
    ids equal; observed boxes equal where finite."""
    _, dets = generate_sequence(n_objects=8, n_frames=20, seed=seed,
                                p_miss=0.1, fp_per_frame=0.2)
    dz = _zero_dets(dets, seed)
    oj, _ = jmot.run_sequence_device(dz, method="iou", capacity=64,
                                     engine="pallas", report_observed=True)
    op, _ = pmot.run_sequence_device(dz, method="iou", capacity=64,
                                     device="cpu", report_observed=True)
    assert _ids(op) == _ids(oj)
    for f in oj:
        np.testing.assert_array_equal(np.asarray(op[f]), np.asarray(oj[f]))


@pytest.mark.parametrize("positional", ["iou", "maha"])
def test_fused_visual_runner_matches_pallas(positional):
    _, dets, feats = generate_sequence(n_objects=8, n_frames=20, seed=3,
                                       p_miss=0.1, fp_per_frame=0.2,
                                       feature_dim=16)
    dz = _zero_dets(dets, 3)
    vj, _ = jmot.run_sequence_device_visual(
        dz, feats, capacity=64, engine="pallas", positional_kind=positional)
    vp, _ = pmot.run_sequence_device_visual(
        dz, feats, capacity=64, device="cpu", positional_kind=positional)
    assert _ids(vp) == _ids(vj)
