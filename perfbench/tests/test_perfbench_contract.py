"""BENCHMARK.json keeps to the names, units and files the harness needs,
and a run without a card or with the JAX package prints no result."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_keep_to_the_character_rule():
    names = [m["name"] for m in METRICS]
    names += [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_cell_and_metric_has_its_files():
    for w in BENCH["workloads"]:
        mix = json.loads((ROOT / "perfbench/mixes"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench/drivers" / f"{mix['driver']}.py").exists()
        assert mix["limits"]["mismatches"] == 0
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in METRICS:
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moves.get("workloads", cells)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def _run(code_or_args, env_extra=None):
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    p = _run(["perfbench/run.py", "--workload", "sort_iou_stream_s4096",
              "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_reference_and_the_generator_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.reference.check, perfbench.traffic,"
            " perfbench.work, perfbench.peaks;"
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib',"
            " 'flax', 'similari_tpu', 'similari_tpu_torch'};"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    p = _run(["-c", code])
    assert p.returncode == 0, p.stdout + p.stderr


def test_the_guard_names_the_jax_package_by_its_whole_top_level_name(
        monkeypatch):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, "similari_tpu_torchx", sys)
    assert "similari_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "similari_tpu.ops", sys)
    assert "similari_tpu" in harness.forbidden_modules()
