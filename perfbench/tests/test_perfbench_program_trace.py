"""The readers of the port's own records (`perfbench/program_trace.py` and
the metrics that use it) on tiny CPU runs of the cells' drivers, on an
empty record and on a port without records."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness

from cells import CPU, run_tiny, tiny_cell

SEED = 2**31 + 29
STEP_METRICS = ("step_syncs", "step_wait_ms", "step_launch_ms")
REPLAY_METRICS = ("chunk_host_ms.replay", "auction_rounds.replay")
ALL = [f"{m}.{k}" for m in STEP_METRICS for k in ("visual", "sort")]
ALL += list(REPLAY_METRICS)


def _read(name):
    return harness.load_module(harness.HERE / "metrics"
                               / f"{name}.py").read({})


@pytest.fixture
def records():
    from similari_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("cell,kind,span", [
    ("vsort512_stream_s1024", "visual", "batched_visual_step"),
    ("sort_iou_stream_s4096", "sort", "batched_sort_step"),
])
def test_step_readers_read_a_tiny_stream_run(records, cell, kind, span):
    run_tiny(cell, SEED, seconds=0.5)
    rec = records.summary()["spans"][span]
    syncs = _read(f"step_syncs.{kind}")
    wait = _read(f"step_wait_ms.{kind}")
    launch = _read(f"step_launch_ms.{kind}")
    # the auction's check after its unrolled rounds, at least once a step
    assert syncs == rec["syncs"] / rec["calls"] >= 1.0
    assert 0.0 < wait < launch
    assert launch + wait == pytest.approx(rec["ns"] / rec["calls"] / 1e6)
    other = "sort" if kind == "visual" else "visual"
    assert all(_read(f"{m}.{other}") is None for m in STEP_METRICS)


def test_replay_readers_read_a_tiny_replay_run(records):
    cell = tiny_cell("vsort512_replay_mot17")
    torch.set_num_threads(2)
    drv = harness.driver(cell).Driver(cell, SEED, CPU)
    drv.setup()
    chunks = records.summary()["spans"]["fused_visual_chunk"]
    assert _read("chunk_host_ms.replay") == pytest.approx(
        chunks["ns"] / chunks["calls"] / 1e6)
    # stats are kept only while a profiler records
    assert _read("auction_rounds.replay") is None
    with profile(activities=[ProfilerActivity.CPU]):
        frames = drv._sequence(0, keep=False)[0]
    kept = records.summary()["kept"]["fused_visual.stats"]
    assert kept["rows"] == frames
    assert _read("auction_rounds.replay") == kept["sum"][0] / frames >= 1.0


def test_every_reader_gives_none_on_an_empty_record(records):
    assert all(_read(name) is None for name in ALL)


def test_every_reader_gives_none_on_a_port_without_records(monkeypatch):
    from similari_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "summary")
    assert all(_read(name) is None for name in ALL)
