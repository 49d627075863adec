"""The port's `eval` metrics and synthetic sequences against the JAX
package's, on the CPU.

`generate_sequence` and both adversarial generators are the same NumPy,
so the same seed gives the same arrays bit for bit; `clear_metrics`,
`identity_metrics` and `iou_matrix_ltwh` are the same NumPy and scipy, so
they give equal results on equal predictions.  The port's runners scored
by the port's metrics meet tests/test_eval.py's bars.
"""

import numpy as np
import pytest

from similari_tpu.eval import metrics as jmetrics
from similari_tpu.eval import synthetic as jsyn
from similari_tpu_torch.eval import (
    clear_metrics,
    generate_adversarial_sequence,
    generate_reid_adversarial_sequence,
    generate_sequence,
    identity_metrics,
    iou_matrix_ltwh,
    run_sequence_device,
    run_sequence_device_visual,
)

from torch_parity import one_cpu_thread

one_cpu_thread()


def assert_bit_equal(a, b, path="out"):
    """Nested dicts / lists / tuples of numbers, arrays or None: equal
    types and structure, floats equal bit for bit."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_bit_equal(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [
    dict(n_objects=12, n_frames=40),
    dict(n_objects=6, n_frames=25, feature_dim=16, birth_death=False),
    dict(n_objects=9, n_frames=30, p_miss=0.2, fp_per_frame=1.5,
         pos_noise=3.0, feature_dim=8),
], ids=["plain", "features", "noisy"])
def test_generate_sequence_bit_equal(seed, kw):
    assert_bit_equal(generate_sequence(seed=seed, **kw),
                     jsyn.generate_sequence(seed=seed, **kw))


@pytest.mark.parametrize("scenario", ["crossing", "fp_burst", "idle_gaps",
                                      "churn", "capacity"])
def test_adversarial_sequence_bit_equal(scenario):
    for seed in (0, 3):
        assert_bit_equal(
            generate_adversarial_sequence(scenario, seed=seed, n_frames=60),
            jsyn.generate_adversarial_sequence(scenario, seed=seed,
                                               n_frames=60))


@pytest.mark.parametrize("scenario", ["reid_crossing", "reid_oriented",
                                      "reid_confusable", "reid_gaps"])
def test_reid_adversarial_sequence_bit_equal(scenario):
    for seed in (0, 3):
        assert_bit_equal(
            generate_reid_adversarial_sequence(scenario, seed=seed,
                                               n_frames=60, feature_dim=16),
            jsyn.generate_reid_adversarial_sequence(
                scenario, seed=seed, n_frames=60, feature_dim=16))


def test_unknown_scenarios_raise_alike():
    for gen in (generate_adversarial_sequence,
                jsyn.generate_adversarial_sequence,
                generate_reid_adversarial_sequence,
                jsyn.generate_reid_adversarial_sequence):
        with pytest.raises(ValueError, match="unknown"):
            gen("nope")


def _noisy_predictions(gt, seed):
    """Ground truth with id swaps, dropped rows, jitter and false
    positives: every metric term is exercised."""
    rng = np.random.default_rng(seed)
    pred = {}
    for f, rows in gt.items():
        out = []
        for tid, l, t, w, h in rows:
            if rng.random() < 0.1:
                continue
            pid = tid + 100 if (f > 20 and tid % 3 == 0) else tid
            out.append((pid, l + rng.normal(0, 2), t + rng.normal(0, 2),
                        w, h))
        if rng.random() < 0.3:
            out.append((999, *rng.uniform(0, 500, 2), 30.0, 60.0))
        if f % 4:
            pred[f] = out
    return pred


@pytest.mark.parametrize("seed", [2, 5])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_metrics_equal_jax(seed, threshold):
    gt, _ = generate_sequence(n_objects=10, n_frames=50, seed=seed)
    pred = _noisy_predictions(gt, seed)
    for ours, ref in ((clear_metrics, jmetrics.clear_metrics),
                      (identity_metrics, jmetrics.identity_metrics)):
        assert_bit_equal(ours(gt, pred, threshold), ref(gt, pred, threshold))
    a = np.random.default_rng(seed).uniform(0, 50, (7, 4))
    b = np.random.default_rng(seed + 1).uniform(0, 50, (5, 4))
    assert_bit_equal(iou_matrix_ltwh(a, b), jmetrics.iou_matrix_ltwh(a, b))
    assert iou_matrix_ltwh(a[:0], b).shape == (0, 5)


def test_metrics_golden_cases():
    """tests/test_eval.py's metric goldens on the port's metrics."""
    gt, _ = generate_sequence(n_objects=8, n_frames=30, seed=1, p_miss=0.0,
                              fp_per_frame=0.0)
    assert clear_metrics(gt, gt)["MOTA"] == pytest.approx(1.0)
    assert identity_metrics(gt, gt)["IDF1"] == pytest.approx(1.0)
    gt = {f: [(1, 0, 0, 10, 10), (2, 100, 0, 10, 10)] for f in (1, 2, 3)}
    pred = {1: [(5, 0, 0, 10, 10), (6, 100, 0, 10, 10)],
            2: [(5, 0, 0, 10, 10), (6, 100, 0, 10, 10)],
            3: [(6, 0, 0, 10, 10), (5, 100, 0, 10, 10)]}
    clear = clear_metrics(gt, pred)
    assert clear["IDSW"] == 2
    assert clear["MOTA"] == pytest.approx(1.0 - 2 / 6)
    assert identity_metrics(gt, pred)["IDF1"] == pytest.approx(4 / 6)
    clear = clear_metrics({1: [(1, 0, 0, 10, 10)]},
                          {1: [(1, 0, 0, 10, 10), (2, 50, 50, 10, 10)]})
    assert clear["TP"] == 1 and clear["FP"] == 1 and clear["FN"] == 0


@pytest.mark.parametrize("method,engine", [("iou", "fused"),
                                           ("iou", "step"),
                                           ("maha", "step")])
def test_runner_accuracy_bars(method, engine):
    """tests/test_eval.py::test_synthetic_tracking_accuracy on the port."""
    gt, dets = generate_sequence(n_objects=15, n_frames=60, seed=3,
                                 p_miss=0.05, fp_per_frame=0.3)
    pred, fps = run_sequence_device(dets, method=method, engine=engine,
                                    report_observed=True, device="cpu")
    assert clear_metrics(gt, pred)["MOTA"] > 0.85
    assert identity_metrics(gt, pred)["IDF1"] > 0.8
    assert fps > 0


def test_clean_detections_near_perfect():
    gt, dets = generate_sequence(n_objects=10, n_frames=40, seed=5,
                                 p_miss=0.0, fp_per_frame=0.0, pos_noise=0.2,
                                 wh_noise=0.1)
    pred, _ = run_sequence_device(dets, method="iou", report_observed=True,
                                  device="cpu")
    clear = clear_metrics(gt, pred)
    assert clear["MOTA"] > 0.99 and clear["IDSW"] == 0
    assert identity_metrics(gt, pred)["IDF1"] > 0.99


def test_visual_runner_accuracy_bars():
    gt, dets, feats = generate_sequence(n_objects=12, n_frames=50, seed=11,
                                        p_miss=0.15, fp_per_frame=0.3,
                                        feature_dim=32)
    pred, fps = run_sequence_device_visual(dets, feats, device="cpu")
    assert clear_metrics(gt, pred)["MOTA"] > 0.75
    assert identity_metrics(gt, pred)["IDF1"] > 0.75
    assert fps > 0
