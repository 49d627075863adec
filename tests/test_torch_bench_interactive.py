"""The port's per-call latency rows (`similari_tpu_torch/bench_interactive.py`
and `bench.py::interactive_host_rows`) against the JAX package's scripts:
the same row keys from a capture, and one JSON line from `main()`.

Only the keys and the line's shape are compared: a time on this machine's
CPU says nothing of the card.  The JAX script's own-area rows jit-compile
its kernel at four widths (most of its minute on one core) and its Kalman
rows loop 100,000 steps in Python, so its kernel and filters are replaced
by stubs that return at once, and the port's Kalman rows take 1,000
steps; the row keys stay the same.
"""

import argparse
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench as jbench  # noqa: E402  (the JAX package's bench.py)
import bench_interactive as jbi  # noqa: E402
import similari_tpu.ops.ownarea as jax_ownarea  # noqa: E402
import similari_tpu.utils.kalman as jax_kalman  # noqa: E402
from similari_tpu_torch import bench as pb  # noqa: E402
from similari_tpu_torch import bench_interactive as pbi  # noqa: E402

from torch_parity import one_cpu_thread  # noqa: E402

one_cpu_thread()

ARGS = dict(objects=[10], reps=3, frames=50, captures=1)


class _Filter:
    def initiate(self, *args):
        return None

    def predict(self, state):
        return state

    def update(self, state, *args):
        return state

    def filter_sequence(self, z):
        return z


def test_measure_rows_equal_the_jax_script(monkeypatch):
    monkeypatch.setattr(jax_ownarea, "own_area_shares",
                        lambda boxes, valid, **_: jnp.ones(boxes.shape[:1]))
    for name in ("Universal2DBoxKalmanFilter", "Point2DKalmanFilter"):
        monkeypatch.setattr(jax_kalman, name, _Filter)
    monkeypatch.setattr(pbi, "KALMAN_STEPS", 1000)
    want = jbi.measure(argparse.Namespace(**ARGS))
    got = pbi.measure(argparse.Namespace(**ARGS, engine="host",
                                         device="cpu"))
    assert sorted(got) == sorted(want)
    assert all(v > 0 for v in got.values())


def test_interactive_host_rows_equal_bench_py():
    want = jbench.bench_interactive_host(reps=2)
    got = pb.interactive_host_rows(reps=2)
    assert sorted(got) == sorted(want)
    assert all(v > 0 for v in got.values())


def test_main_prints_one_line(monkeypatch, capsys):
    """Two captures of a stubbed measure: per-row medians, the spread, the
    engine and the device recorded."""
    caps = iter([{"sort_10_ms": 2.0, **rows} for rows in (
        {f"{p}_{n}_ms": 1.0 for p, refs in pbi.REFS.items() for n in refs},
        {f"{p}_{n}_ms": 3.0 for p, refs in pbi.REFS.items() for n in refs})])
    monkeypatch.setattr(pbi, "measure", lambda args: next(caps))
    assert pbi.main(["--device", "cpu", "--objects", "10", "--captures",
                     "2", "--engine", "device"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["engine"] == "device" and line["device"] == "cpu"
    assert line["platform"] == "cpu" and line["captures"] == 2
    assert line["rows"]["sort_10_ms"] == 2.0
    assert line["rows"]["visual_10_ms"] == 2.0
    assert line["spread_ms"]["visual_10_ms"] == [1.0, 3.0]
    assert line["vs_reference"]["sort_10_x_reference"] == round(0.149 / 2, 4)
    assert sorted(line["vs_reference"]) == sorted(
        ["sort_10_x_reference"] + [f"{p}_{n}_x_reference"
                                   for p, refs in pbi.REFS.items()
                                   for n in refs])


@pytest.mark.parametrize("bad", [["--engine", "auto"], ["--device", "tpu"]])
def test_only_explicit_engines_and_devices(bad):
    with pytest.raises(SystemExit):
        pbi.parse_args(bad)
