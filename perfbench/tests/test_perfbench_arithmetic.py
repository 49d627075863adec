"""The roofline arithmetic against shapes worked by hand, and each reader
on a hand-made record."""

from pathlib import Path

import numpy as np
import pytest

from perfbench import harness, peaks, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py").read


def profile(**kernels):
    return harness.Profile(window_s=2.0, busy_s=1.5, kernels=kernels,
                           span_busy_s={"perfbench.step": 1e-9,
                                        "perfbench.scan": 1e-9},
                           device_ops=[], idle_gaps=[])


def test_least_time_takes_the_larger_bound():
    assert peaks.least_time(67e12, 0.0) == (1.0, "operations")
    assert peaks.least_time(0.0, 3.35e12) == (1.0, "bytes")
    assert peaks.least_time(67e12, 6.7e12) == (2.0, "bytes")


def test_step_work_by_hand():
    # SORT: 10 rows, 20 tracks: 15 x 200 ops; 10 x 15 + 20 x 40 + 10 x 40
    # words
    assert work.step_work([10], [20], False) == (3000.0, 5400.0)
    # VisualSORT, F = 4, K = 2: + 10 x 20 x 2 x 11 + 8 x (10 + 40) ops,
    # + 40 + 160 + 80 words
    assert work.step_work([10], [20], True, 4, 2) == (7800.0, 6520.0)


def test_step_roofline_reads_the_step_span():
    ops, nbytes = work.step_work(np.array([10, 12]), np.array([20, 20]),
                                 False)
    run = dict(profile=profile(), work=[(np.array([10, 12]),
                                         np.array([20, 20]))],
               shape=dict(visual=False, feature_dim=0, gallery=0))
    want = 100 * max(ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES) / 1e-9
    assert reader("step_roofline.sort")(run) == pytest.approx(want)


def test_gallery_dots_roofline_by_hand():
    # one chunk of 2 frames x 3 rows (N = 6), 5 live tracks x 2 lanes
    # (M = 10), F = 4: 6 x 10 + 9 x 1 needed products; 2F x 69 + 2F x 16
    # ops; 4 x (16 x 4 + 69 + 16) bytes
    least = max(680 / peaks.F32_FLOPS, 596 / peaks.HBM_BYTES)
    run = dict(profile=profile(**{"gallery_dots_kernel(x)": (2 * least, 1)}),
               work=[(np.array([3, 3]), np.array([5, 5]))],
               shape=dict(feature_dim=4, gallery=2, chunk=2, dpad=3))
    assert reader("gallery_dots_roofline")(run) == pytest.approx(50.0)


def test_gallery_dots_roofline_counts_valid_rows_not_padding():
    # rows padded to 8, of which 2 and 3 valid (N = 5), 5 live tracks x 2
    # lanes (M = 10), F = 4: 5 x 10 + 2 x 3 needed products; 2F x 56 +
    # 2F x 15 ops; 4 x (15 x 4 + 56 + 15) bytes
    least = max(568 / peaks.F32_FLOPS, 524 / peaks.HBM_BYTES)
    run = dict(profile=profile(**{"gallery_dots_kernel(x)": (4 * least, 1)}),
               work=[(np.array([2, 3]), np.array([5, 5]))],
               shape=dict(feature_dim=4, gallery=2, chunk=2, dpad=8))
    assert reader("gallery_dots_roofline")(run) == pytest.approx(25.0)


def test_merge_roofline_by_hand():
    # 2 launches a step; 5 + 7 rows of 4 f32 read and written; 8 bytes of
    # row and mask per padded row (2 scenes x 8 rows)
    nbytes = 2 * (2 * 12 * 16 + 8 * 2 * 8)
    t = nbytes / peaks.HBM_BYTES
    run = dict(profile=profile(**{"void lane_merge_kernel": (4 * t, 2)}),
               work=[(np.array([5, 7]), np.array([9, 9]))],
               shape=dict(feature_dim=4, scenes=2, dpad=8))
    assert reader("merge_roofline")(run) == pytest.approx(25.0)


def test_idle_share_and_end_to_end_readers():
    run = dict(profile=profile(), step_s=[0.01] * 19 + [0.03], call_s=[0.002],
               scene_frames=300, window_s=2.0, setup_s=3.5)
    assert reader("idle_share.visual")(run) == pytest.approx(25.0)
    assert reader("scene_fps.visual")(run) == 150.0
    assert reader("step_p95_ms.sort")(run) == pytest.approx(11.0)
    assert reader("step_host_ms.visual")(run) == pytest.approx(2.0)
    assert reader("setup_s")(run) == 3.5
    assert reader("replay_fps")(run) is None


def test_readers_find_nothing_without_a_profile():
    for name in ("step_roofline.visual", "step_roofline.sort",
                 "merge_roofline", "scan_roofline", "fused_visual_roofline",
                 "gallery_dots_roofline", "idle_share.visual",
                 "idle_share.sort", "idle_share.replay"):
        assert reader(name)({"profile": None}) is None
