"""The port's adversarial accuracy suite (`similari_tpu_torch/tools/
adversarial_suite.py`) against the JAX package's `tools/
adversarial_suite.py`, imported by path, on the CPU.

For `crossing` and `idle_gaps` (seed 0, 80 frames) on every SORT axis,
and `reid_crossing` (seed 0, 80 frames) on every VisualSORT axis, the
port's `run_axis` / `run_visual_axis` must give the JAX tool's
predictions on the same axis: the same track ids in every frame, boxes
within tests/torch_parity.py's RTOL/ATOL (the device runners report the
Kalman prediction, which the two packages round differently), and so the
same MOTA and IDF1.  The port's `vfused` axis (the fused kernel's plain
version here) is held to the JAX tool's `vhost` axis, not to its Pallas
kernel in interpret mode.  Then the suite's `main()` on a reduced run: a
parseable line, the artifact, and `refused` rows where the fused engine
refuses a configuration.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from similari_tpu_torch.tools import adversarial_suite as padv

from torch_parity import ATOL, RTOL, one_cpu_thread

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_adversarial_suite", ROOT / "tools" / "adversarial_suite.py")
jadv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jadv)

CPU = torch.device("cpu")
FRAMES = 80
# the port's axis -> the JAX tool's axis it is held to
JAX_AXIS = {"vfused": "vhost"}


def _same_predictions(got, want):
    assert sorted(got) == sorted(want)
    for frame in want:
        assert [r[0] for r in got[frame]] == [r[0] for r in want[frame]], \
            frame
        if want[frame]:
            np.testing.assert_allclose(
                np.array([r[1:] for r in got[frame]]),
                np.array([r[1:] for r in want[frame]]), rtol=RTOL,
                atol=ATOL)


def _same_scores(gt, got, want):
    for a, b in zip(padv.score(gt, got), padv.score(gt, want)):
        assert abs(a - b) <= 1e-9


@pytest.fixture(scope="module")
def sort_streams():
    return {s: padv.SortRunner(s, CPU).make(0, n_frames=FRAMES)
            for s in ("crossing", "idle_gaps")}


@pytest.fixture(scope="module")
def reid_stream():
    return padv.VisualRunner("reid_crossing", CPU).make(0, n_frames=FRAMES)


@pytest.mark.parametrize("axis", padv.SORT_AXES)
@pytest.mark.parametrize("scenario", ["crossing", "idle_gaps"])
def test_sort_axis_gives_the_jax_tools_predictions(sort_streams, scenario,
                                                   axis):
    runner = padv.SortRunner(scenario, CPU)
    gt, dets = sort_streams[scenario]
    got = runner.run(axis, (gt, dets))
    want = jadv.run_axis(axis, dets, runner.capacity)
    _same_predictions(got, want)
    _same_scores(gt, got, want)


@pytest.mark.parametrize("axis", padv.REID_AXES["reid_crossing"])
def test_visual_axis_gives_the_jax_tools_predictions(reid_stream, axis):
    runner = padv.VisualRunner("reid_crossing", CPU)
    gt, dets, feats, quals = reid_stream
    got = runner.run(axis, reid_stream)
    want = jadv.run_visual_axis(JAX_AXIS.get(axis, axis), dets, feats,
                                quals, runner.capacity)
    _same_predictions(got, want)
    _same_scores(gt, got, want)


def test_axes_and_configuration_are_the_jax_tools():
    assert padv.SORT_SCENARIOS == jadv.SORT_SCENARIOS
    assert padv.SORT_AXES == jadv.SORT_AXES
    # the fused kernel's axis is the JAX tool's `vpallas`, renamed
    assert {k: tuple("vpallas" if a == "vfused" else a for a in v)
            for k, v in padv.REID_AXES.items()} == jadv.REID_AXES
    assert padv.VIS == jadv.VIS and padv.OWN_AREA == jadv.OWN_AREA


def test_fused_refusal_is_recorded(monkeypatch):
    """A configuration the fused engine refuses gives a `refused` row and
    no other engine's numbers."""
    from similari_tpu_torch.ops import fused_visual

    def refuse(*a, **k):
        raise ValueError("past the kernel's shared memory: use "
                         "engine='step'")

    monkeypatch.setattr(fused_visual, "check_visual_shape", refuse)
    runner = padv.VisualRunner("reid_crossing", CPU)
    monkeypatch.setattr(runner, "make",
                        lambda seed: padv.VisualRunner(
                            "reid_crossing", CPU).make(seed, n_frames=12))
    results, lines = {}, []
    padv.score_block("reid_crossing", ("vhost", "vfused"), runner, [0],
                     results, lines)
    assert results["reid_crossing_vfused"] == {
        "refused": "past the kernel's shared memory: use engine='step'"}
    assert "MOTA" in results["reid_crossing_vhost"]


def test_main_prints_a_line_and_writes_the_artifact(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(padv, "SORT_FRAMES", FRAMES)
    out = tmp_path / "adv.json"
    rc = padv.main(["--device", "cpu", "--seeds", "0", "--family", "sort",
                    "--out", str(out)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "adversarial_worst_delta_pt"
    assert line["device"] == "cpu" and line["pass"] is True
    blob = json.loads(out.read_text())
    assert set(blob["rows"]) == {f"{s}_{a}" for s in padv.SORT_SCENARIOS
                                 for a in padv.SORT_AXES}
    assert blob["worst_abs_delta_pt"] == line["value"]
