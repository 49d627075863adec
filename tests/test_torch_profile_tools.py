"""The port's profilers (`similari_tpu_torch/tools/profile_gallery.py`,
`profile_oriented.py`) at tiny sizes on the CPU, and every entry point of
the port's tools, harness and examples raising without CUDA.

Each profiler must exit 0 and print one parseable JSON line with its
rows: the gallery split for groups of 1 and 2 gloo ranks (the payload
n x Q x k x 16 bytes, the lanes of the grown gallery, positive times),
and both of the oriented call's 500-box splits.  The oriented profiler's
stream must be the JAX tool's, bit for bit.  Without `--device cpu`
every entry point raises before it measures: the CPU has no CUDA.
"""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from similari_tpu_torch.tools import profile_gallery, profile_oriented

from torch_parity import one_cpu_thread

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
ENTRY_POINTS = sorted(
    ["similari_tpu_torch.bench_pod"]
    + [f"similari_tpu_torch.tools.{p.stem}"
       for p in (ROOT / "similari_tpu_torch" / "tools").glob("*.py")
       if p.stem != "__init__"]
    + [f"similari_tpu_torch.examples.{p.stem}"
       for p in (ROOT / "similari_tpu_torch" / "examples").glob("*.py")
       if p.stem != "__init__"])


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_gallery_prints_its_rows(capsys):
    rc = profile_gallery.main([
        "--device", "cpu", "--devices", "2", "--scenes-per-device", "2",
        "--objects", "8", "--feat-dim", "16", "--queries", "8", "--topk",
        "4", "--calls", "3", "--point-reps", "2"])
    assert rc == 0
    line = _line(capsys)
    assert line["metric"] == "gallery_query_profile"
    assert line["device"] == "cpu" and set(line["rows"]) == {"n1", "n2"}
    for n in (1, 2):
        r = line["rows"][f"n{n}"]
        assert r["gather_payload_bytes"] == n * 8 * 4 * 16
        assert r["gallery_lanes"] == 2 * n * 2 * 8 * 3
        assert r["full_ms"] > 0 and r["scoring_ms"] > 0 and r["qps_total"] > 0
        assert r["full_spread_ms"][0] <= r["full_ms"] <= r["full_spread_ms"][1]
        assert np.isclose(r["gather_merge_ms"],
                          r["full_ms"] - r["scoring_ms"], atol=2e-4)


def test_profile_oriented_prints_both_splits(capsys):
    rc = profile_oriented.main(["--device", "cpu", "--reps", "3"])
    assert rc == 0
    line = _line(capsys)
    assert line["metric"] == "oriented_500_cost_split"
    assert line["device"] == "cpu" and line["objects"] == 500
    for key in ("oriented_full_ms", "oriented_native_ms", "aligned_full_ms",
                "aligned_native_ms", "aligned_forced_oriented_native_ms",
                "device_call_ms"):
        assert line[key] > 0, key
    assert line["tracks_active"] == 500
    assert line["pair_weight_calls"] >= 500
    # the CPU runs the clip's plain version: no kernel launch to count
    assert line["clip_launches_per_call"] == 0


def test_oriented_stream_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_oriented", ROOT / "tools" / "profile_oriented.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    for oriented in (True, False):
        a = profile_oriented.make_stream(30, oriented)
        b = jtool.make_stream(30, oriented)
        for _ in range(3):
            for x, y in zip(a(), b()):
                np.testing.assert_array_equal(x, y)


def test_entry_points_cover_the_new_modules():
    assert len(ENTRY_POINTS) == 1 + 8 + 22


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_raises_without_cuda(module, capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(module).main([])
    assert capsys.readouterr().out == ""
