"""The port's step timer and profiler trace (`utils/profiling.py`)."""

import json

import pytest
import torch

from similari_tpu.utils.profiling import StepTimer as JaxStepTimer
from similari_tpu_torch.utils import StepTimer, trace

from torch_parity import one_cpu_thread

one_cpu_thread()


@pytest.mark.parametrize("timer_cls", [StepTimer, JaxStepTimer])
def test_step_timer(timer_cls):
    """tests/test_checkpoint.py::test_step_timer, for both packages."""
    t = timer_cls()
    with t.step(scenes=4):
        pass
    assert t.total_scenes == 4
    assert t.scenes_per_sec > 0
    assert "steps_per_sec" in t.summary()


def test_step_timer_counts_like_jax():
    """Equal samples give equal rates and summaries in both packages."""
    ours, theirs = StepTimer(window=2), JaxStepTimer(window=2)
    for t in (ours, theirs):
        t.samples.extend([(0.5, 3), (0.25, 1), (0.25, 4)])
        t.total_steps, t.total_scenes = 3, 8
    assert ours.summary() == theirs.summary() == {
        "steps_per_sec": 4.0, "scenes_per_sec": 10.0, "total_steps": 3,
        "total_scenes": 8}
    assert StepTimer().steps_per_sec == StepTimer().scenes_per_sec == 0.0


def test_trace_on_the_cpu_writes_a_chrome_trace_naming_the_ops(tmp_path):
    with trace(str(tmp_path), device="cpu") as log_dir:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert log_dir == str(tmp_path)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default records it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with trace(str(tmp_path)):
            pass
    assert not list(tmp_path.glob("trace_*.json"))
