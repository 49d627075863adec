"""The port's examples (`similari_tpu_torch/examples/`) against the JAX
package's `examples/*.py`.

Every JAX example has a port module of the same name.  Each port example
runs in this process with `--device cpu` and `SIMILARI_EXAMPLE_FAST=1`
(`runpy`, as `python -m` would run it) and must exit cleanly; its printed
lines must equal the JAX example's, run here too under the same
environment, character for character.  Lines that carry a time or rate
are compared with the rate masked (`RATE_LINES`), and there the engines'
names too, which differ by package (the JAX general step is "xla" and
its fused kernel "pallas"; the port's are "step" and "fused").
`cross_camera_handoff` spawns 4 gloo ranks; the JAX example runs on 4 of
this process's 8 virtual devices, so both run 4 shards.
"""

import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

from torch_parity import one_cpu_thread

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
PORT_EXAMPLES = sorted(
    p.stem for p in (ROOT / "similari_tpu_torch" / "examples").glob("*.py")
    if p.stem != "__init__")
# example -> (pattern of a rate in its lines, what the pattern becomes)
RATE_LINES = {
    "visual_pallas_pipeline": (r"\b(xla|pallas|step|fused) \d+ FPS",
                               "<engine> <rate> FPS"),
}


def _printed(run, monkeypatch):
    """The lines `run()` prints to stdout."""
    monkeypatch.setenv("SIMILARI_EXAMPLE_FAST", "1")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run()
    return buf.getvalue().splitlines()


def _masked(name, lines):
    if name not in RATE_LINES:
        return lines
    pattern, repl = RATE_LINES[name]
    return [re.sub(pattern, repl, ln) for ln in lines]


def test_every_jax_example_has_a_port_example():
    assert JAX_EXAMPLES == PORT_EXAMPLES
    assert len(JAX_EXAMPLES) == 22


@pytest.mark.parametrize("name", JAX_EXAMPLES)
def test_port_example_prints_the_jax_examples_lines(name, monkeypatch):
    module = f"similari_tpu_torch.examples.{name}"
    # run as `python -m` would, not as a module another test imported
    monkeypatch.delitem(sys.modules, module, raising=False)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--device", "cpu"])
    port = _printed(lambda: runpy.run_module(module, run_name="__main__"),
                    monkeypatch)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    want = _printed(lambda: runpy.run_path(
        str(ROOT / "examples" / f"{name}.py"), run_name="__main__"),
        monkeypatch)
    assert port, name
    assert _masked(name, port) == _masked(name, want)
    if name in RATE_LINES:  # the masked lines did carry a rate
        assert _masked(name, port) != port
