"""Frames given as an empty list in the port's runners (`eval/mot.py`).

A detections dict may hold `{frame: []}`: a frame with no detection.  Every
runner of the port reads it as [0, 5] rows that step with no detection,
and its run equals the JAX package's runner given the same frame as
`np.zeros((0, 7))` (its runners index `dets[:, 0]`, which a list of no
rows does not have).  Ids must be equal on every frame, the empty frame
reported as `[]`; boxes are held at 1e-4 (Kalman outputs for SORT, copies
of the input for VisualSORT).
"""

import numpy as np
import pytest

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu.eval import mot as jmot
from similari_tpu_torch.eval import mot as pmot

from torch_parity import one_cpu_thread

one_cpu_thread()

FRAMES = list(range(1, 13))
EMPTY = (1, 5, 6, 12)  # the first frame, two in a row, the last
N_OBJ, FDIM = 5, 6


def _sequence(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (N_OBJ, 2))
    ident = rng.normal(size=(N_OBJ, FDIM))
    dets, feats = {}, {}
    for f in FRAMES:
        xy = xy + rng.uniform(-2, 2, xy.shape)
        dets[f] = [(float(x) - 12, float(y) - 20, 24.0, 40.0,
                    float(rng.uniform(0.5, 1))) for x, y in xy]
        feats[f] = [(ident[i] + 0.05 * rng.normal(size=FDIM)).tolist()
                    for i in range(N_OBJ)]
    return dets, feats


def _with_empty(dets, feats, empty):
    """(port inputs with `[]` at the empty frames, JAX inputs with
    np.zeros((0, 7)) there)."""
    p_dets = {f: ([] if f in EMPTY else v) for f, v in dets.items()}
    j_dets = {f: (empty if f in EMPTY else v) for f, v in dets.items()}
    e_feats = {f: ([] if f in EMPTY else v) for f, v in feats.items()}
    return (p_dets, e_feats), (j_dets, e_feats)


def _assert_same(out_j, out_p):
    assert list(out_p) == list(out_j) == FRAMES
    for f in FRAMES:
        assert [r[0] for r in out_p[f]] == [r[0] for r in out_j[f]], f
        if f in EMPTY:
            assert out_p[f] == []
            continue
        np.testing.assert_allclose(np.array([r[1:] for r in out_p[f]]),
                                   np.array([r[1:] for r in out_j[f]]),
                                   rtol=1e-4, atol=1e-4)


def _opts(pkg):
    return (pkg.VisualSortOptions().max_idle_epochs(4)
            .visual_metric(pkg.VisualSortMetricType.euclidean(2.0))
            .visual_minimal_track_length(1)
            .positional_metric(pkg.PositionalMetricType.iou(0.3)))


RUNNERS = {
    "device_sort_fused": lambda mot, d, f, **kw: mot.run_sequence_device(
        d, capacity=16, **kw),
    "device_sort_step": lambda mot, d, f, **kw: mot.run_sequence_device(
        d, capacity=16, **kw),
    "device_visual_fused": lambda mot, d, f, **kw:
        mot.run_sequence_device_visual(d, f, capacity=16,
                                       feature_precision="f32", **kw),
    "device_visual_step": lambda mot, d, f, **kw:
        mot.run_sequence_device_visual(d, f, capacity=16,
                                       feature_precision="f32", **kw),
}
# the JAX runner each port engine is held to: its fused kernels in
# interpret mode, and its general step
JAX_ENGINE = {"fused": "pallas", "step": "xla"}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_device_runners_read_an_empty_list_as_no_detection(name):
    dets, feats = _sequence(1)
    (pd, pf), (jd, jf) = _with_empty(dets, feats, np.zeros((0, 7)))
    engine = name.rsplit("_", 1)[1]
    out_j, _ = RUNNERS[name](jmot, jd, jf, engine=JAX_ENGINE[engine])
    out_p, fps = RUNNERS[name](pmot, pd, pf, engine=engine, device="cpu")
    _assert_same(out_j, out_p)
    assert fps > 0


@pytest.mark.parametrize("engine", ["host", "device"])
def test_interactive_runners_read_an_empty_list_as_no_detection(engine):
    dets, feats = _sequence(2)
    (pd, pf), (jd, jf) = _with_empty(dets, feats, np.zeros((0, 7)))

    def sort(pkg, **kw):
        return pkg.Sort(1, method=pkg.PositionalMetricType.iou(0.3),
                        max_idle_epochs=4, **kw)

    out_j = jmot.run_sequence_interactive(sort(jx, engine="device"), jd)
    out_p = pmot.run_sequence_interactive(
        sort(pt, engine=engine, device="cpu"), pd)
    _assert_same(out_j, out_p)
    vj = jmot.run_sequence_interactive_visual(
        jx.VisualSort(1, _opts(jx), engine="device"), jd, jf)
    vp = pmot.run_sequence_interactive_visual(
        pt.VisualSort(1, _opts(pt), engine=engine, device="cpu"), pd, pf)
    _assert_same(vj, vp)


def test_frame_rows_keeps_rows_and_reads_empty_as_five_columns():
    assert pmot.frame_rows([]).shape == (0, 5)
    assert pmot.frame_rows(np.zeros((0, 7))).shape == (0, 5)
    rows = [(1.0, 2.0, 3.0, 4.0, 0.5, 0.1)]
    np.testing.assert_array_equal(pmot.frame_rows(rows),
                                  np.asarray(rows, np.float32))
