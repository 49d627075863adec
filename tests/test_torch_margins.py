"""The port's decision-margin tool (`similari_tpu_torch/tools/
decision_margins.py`) against the JAX package's `tools/
decision_margins.py`, imported by path, on the CPU.

On seed 0 of each adversarial ReID scenario (the first FRAMES frames: the
crossing's first claims come after frame 80), the port's `run_scenario`
must give the JAX tool's claim margins, row margins, gate margins, bf16
deltas, own-area gate margins, exact ties and competing pairs exactly,
and its own-area host/device deltas within 1e-6 (the port's f32 shares
against JAX's).  `round_bf16`, the port's bf16 rounding, must be bit-equal
to `ml_dtypes.bfloat16`, the JAX tool's.  `main()` must summarise as the
JAX tool does and write only where `--out` says.
"""

import functools
import hashlib
import importlib.util
import json
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import similari_tpu.eval.synthetic as jsyn
from similari_tpu_torch.ops.gallery_dots import round_bf16
from similari_tpu_torch.tools import decision_margins as pdm

from torch_parity import one_cpu_thread

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_decision_margins", ROOT / "tools" / "decision_margins.py")
jdm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdm)

CPU = torch.device("cpu")
FRAMES = {"reid_crossing": 100, "reid_confusable": 60, "reid_gaps": 80}
EXACT = ("claim", "row", "gate", "bf16", "oag", "ties", "pairs")


@pytest.fixture(scope="module")
def runs():
    """{scenario: (JAX tool's records, port's records)} on seed 0."""
    orig = jsyn.generate_reid_adversarial_sequence
    out = {}
    try:
        for scenario, n in FRAMES.items():
            jsyn.generate_reid_adversarial_sequence = functools.partial(
                orig, n_frames=n)
            own_area = scenario == "reid_crossing"
            out[scenario] = (
                jdm.run_scenario(scenario, [0], own_area=own_area),
                pdm.run_scenario(scenario, [0], own_area=own_area,
                                 device=CPU, n_frames=n))
    finally:
        jsyn.generate_reid_adversarial_sequence = orig
    return out


@pytest.mark.parametrize("scenario", pdm.SCENARIOS)
def test_run_scenario_matches_jax_tool(runs, scenario):
    want, got = runs[scenario]
    for key in EXACT:
        assert got[key] == want[key], key
    # every probe sees decisions on these frames
    assert want["claim"] and want["row"] and want["bf16"] and want["gate"]
    assert len(got["oad"]) == len(want["oad"])
    np.testing.assert_allclose(got["oad"], want["oad"], rtol=0, atol=1e-6)
    if scenario == "reid_crossing":
        assert len(want["oad"]) == FRAMES[scenario] // pdm.OWN_AREA_EVERY


def _jax_row(st):
    """The JAX tool's `main` summary of one scenario's records."""
    mc, mr = min(st["claim"]), min(st["row"])
    mb, mg = max(st["bf16"]), min(st["gate"])
    row = {"min_claim_margin": mc, "min_row_margin": mr,
           "exact_ties": st["ties"], "competing_pairs": st["pairs"],
           "max_bf16_weight_delta": mb, "min_gate_margin": mg,
           "bf16_flippable_votes": sum(1 for g in st["gate"] if g <= mb),
           "claim_margin_over_bf16": mc / mb,
           "n_claim": len(st["claim"]), "n_row": len(st["row"])}
    if st["oad"]:
        row["max_ownarea_host_dev_delta"] = max(st["oad"])
        row["min_ownarea_gate_margin"] = min(st["oag"])
    return row


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_main_summarises_as_the_jax_tool(runs, monkeypatch, tmp_path,
                                         capsys):
    ports = {s: got for s, (_, got) in runs.items()}
    monkeypatch.setattr(pdm, "run_scenario",
                        lambda scenario, seeds, **kw: ports[scenario])
    committed = _digest(ROOT / "MARGINS_r05.json")
    out = tmp_path / "margins.json"
    rc = pdm.main(["--device", "cpu", "--seeds", "0", "--out", str(out)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    blob = json.loads(out.read_text())
    assert line["metric"] == "min_claim_margin_over_bf16_delta"
    assert line["device"] == blob["device"] == "cpu"
    assert blob["seeds"] == [0]
    assert blob["note"] == pdm.NOTE
    for scenario, (want, _) in runs.items():
        assert blob["rows"][scenario] == _jax_row(want), scenario
    assert line["value"] == min(r["claim_margin_over_bf16"]
                                for r in blob["rows"].values())
    lines = blob["table_md"].splitlines()
    assert len(lines) == 2 + len(pdm.SCENARIOS)
    assert _digest(ROOT / "MARGINS_r05.json") == committed
    assert list(tmp_path.iterdir()) == [out]


def _bits_f32(x):
    return x.view(np.uint32)


def _cases():
    rng = np.random.default_rng(0)
    random = (rng.normal(size=4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(np.float32)
    hi = rng.integers(0, 1 << 16, 4096, dtype=np.uint32)
    ties = ((hi << 16) | 0x8000).view(np.float32)  # exactly half-way
    ties = ties[np.isfinite(ties)]
    sub = rng.integers(1, 1 << 23, 4096, dtype=np.uint32)
    sub = (sub | (rng.integers(0, 2, 4096, dtype=np.uint32) << 31)).view(
        np.float32)
    inf = np.array([np.inf, -np.inf, np.finfo(np.float32).max,
                    -np.finfo(np.float32).max], np.float32)
    inf = np.concatenate([inf, np.array([0x7F7F8000, 0x7F7F7FFF, 0xFF7F8000],
                                        np.uint32).view(np.float32)])
    nan = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                    0x7FA00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7FC12345],
                   np.uint32).view(np.float32)
    return {"random": random, "ties": ties, "subnormals": sub,
            "infinities": inf, "nans": nan,
            "zeros": np.array([0.0, -0.0], np.float32)}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_round_bf16_matches_ml_dtypes(case):
    x = _cases()[case]
    got = round_bf16(torch.from_numpy(x.copy())).numpy()
    with np.errstate(invalid="ignore"):  # ml_dtypes warns on NaN casts
        want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(_bits_f32(got), _bits_f32(want))
