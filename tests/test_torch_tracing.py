"""The port's tracing (`utils/profiling.py`) on the CPU: spans nest and
time themselves, waits and counters count, the batched steps and the fused
scan record their stages, and tracing changes nothing the step computes
or runs."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.ops import fused_visual as fv
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig
from similari_tpu_torch.trackers.state import map_tensors
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import VisualConfig
from similari_tpu_torch.utils import profiling

from torch_parity import one_cpu_thread, sort_stream, visual_stream

one_cpu_thread()

S, D, T, K, F = 3, 16, 32, 3, 16
VCFG = VisualConfig(iou_threshold=0.3, visual_threshold=100.0,
                    visual_minimal_track_length=1, max_idle_epochs=5,
                    assignment="auction", oriented=False, recycle_idle=True)
SCFG = SortConfig(method="iou", assignment="auction", oriented=False,
                  recycle_idle=True)
VISUAL_STAGES = ("visual_step.weights", "visual_step.votes",
                 "visual_step.best_fit", "visual_step.auction",
                 "visual_step.slots_kalman", "visual_step.gallery",
                 "visual_step.state_write", "merge_inplace.feats",
                 "merge_inplace.hist_feat")
SORT_STAGES = ("sort_step.weights", "sort_step.auction",
               "sort_step.slots_kalman", "sort_step.state_write")


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.reset()
    yield
    profiling.reset()


def _visual_frames(steps=4):
    """[steps] frames of S scenes: (box, conf, valid, feat, fvalid, qual,
    own area) tensors [S, D, ...]."""
    scenes = [visual_stream(20 + s, steps, D, F) for s in range(S)]
    return [tuple(torch.tensor(np.stack([sc[j][i] for sc in scenes]))
                  for j in range(7)) for i in range(steps)]


def _sort_frames(steps=4):
    scenes = [sort_stream(30 + s, steps, D) for s in range(S)]
    out = []
    for i in range(steps):
        box = torch.tensor(np.stack([sc[0][i] for sc in scenes]))
        valid = torch.tensor(np.stack([sc[1][i] for sc in scenes]))
        out.append((box, torch.ones(S, D), valid))
    return out


def _run_visual(frames, state=None):
    step = pmesh.batched_visual_step_inplace(VCFG)
    if state is None:
        state = pmesh.new_batched_visual_state(S, T, 1, K, F, device="cpu")
    outs = []
    for i, fr in enumerate(frames):
        state, out = step(state, *fr, torch.full((S,), i + 1,
                                                 dtype=torch.int32))
        outs.append(out)
    return state, outs


def _run_sort(frames):
    step = pmesh.batched_sort_step(SCFG)
    state = pmesh.new_batched_state(S, T, 1, device="cpu")
    outs = []
    for i, fr in enumerate(frames):
        state, out = step(state, *fr, torch.full((S,), i + 1,
                                                 dtype=torch.int32))
        outs.append(out)
    return state, outs


def _tensors(x):
    """Every tensor of a nest of dataclasses and sequences, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return _tensors(list(vars(x).values()))


def _assert_bit_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

def test_spans_nest_record_their_parent_and_self_time():
    with profiling.span("outer"):
        with profiling.span("inner"):
            with profiling.wait("site"):
                pass
        with profiling.span("inner"):
            pass
    with profiling.span("outer"):
        pass
    s = profiling.summary()["spans"]
    outer, inner, site = s["outer"], s["inner"], s["site"]
    assert (outer["calls"], inner["calls"], site["calls"]) == (2, 2, 1)
    assert outer["parent"] is None
    assert inner["parent"] == "outer" and site["parent"] == "inner"
    assert outer["ns"] >= inner["ns"] >= site["ns"] > 0
    assert outer["self_ns"] == outer["ns"] - inner["ns"]
    assert inner["self_ns"] == inner["ns"] - site["ns"]
    assert site["self_ns"] == site["ns"]
    # a wait's time and sync count in every span around it
    assert outer["syncs"] == inner["syncs"] == site["syncs"] == 1
    assert (outer["wait_ns"] == inner["wait_ns"] == site["wait_ns"]
            == site["ns"])
    assert profiling.summary()["waits"] == {
        "site": {"syncs": 1, "ns": site["ns"]}}


def test_a_span_closes_when_its_block_raises():
    with pytest.raises(KeyError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise KeyError("x")
    with profiling.span("after"):
        pass
    s = profiling.summary()["spans"]
    assert s["inner"]["parent"] == "outer"
    assert s["after"]["parent"] is None


def test_spanned_functions_are_spans():
    @profiling.spanned("fn")
    def fn(x, y=1):
        """Doc."""
        return x + y

    assert fn(2, y=3) == 5 and fn.__doc__ == "Doc."
    assert profiling.summary()["spans"]["fn"]["calls"] == 1


def test_counters_count_and_reset_clears_every_record():
    profiling.count("a")
    profiling.count("a", 4)
    profiling.count("b", 2)
    with profiling.span("s"):
        pass
    assert profiling.counter("a") == 5 and profiling.counter("none") == 0
    profiling.keep("k", torch.ones(2, 3))  # no profiler: not kept
    s = profiling.summary()
    assert s["counts"] == {"a": 5, "b": 2}
    assert s["kept"] == {}
    profiling.reset()
    assert profiling.summary() == {"counts": {}, "spans": {}, "waits": {},
                                   "kept": {}}


def test_keep_holds_tensors_only_under_a_profiler():
    x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.keep("k", x)
        profiling.keep("k", x[:1])
    profiling.keep("k", x)
    kept = profiling.summary()["kept"]["k"]
    assert kept == {"tensors": 2, "rows": 4, "sum": [6.0, 10.0]}


def test_trace_writes_the_summary_beside_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("traced"):
            profiling.count("c", 3)
    traces = list(tmp_path.glob("trace_*.json"))
    summaries = list(tmp_path.glob("summary_*.json"))
    assert len(traces) == len(summaries) == 1
    assert traces[0].name[len("trace_"):] == summaries[0].name[
        len("summary_"):]
    summ = json.loads(summaries[0].read_text())
    assert summ["counts"] == {"c": 3}
    assert summ["spans"]["traced"]["calls"] == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "traced" for e in events)


def test_device_events_leave_out_the_device_copies_of_spans():
    """On the card every `record_function` range, a span's too, has a copy
    on the device's timeline flagged `is_user_annotation`: no kernel."""
    def event(name, device, annotation=False):
        return type("Event", (), dict(name=name, device_type=device,
                                      is_user_annotation=annotation))()

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [event("gallery_dots", cpu), event("gallery_dots", cuda, True),
              event("gallery_dots_kernel", cuda), event("Memcpy DtoD", cuda)]
    prof = type("Prof", (), dict(events=lambda self: events))()
    assert [e.name for e in profiling.device_events(prof)] == [
        "gallery_dots_kernel", "Memcpy DtoD"]


# --------------------------------------------------------------------------
# the batched steps
# --------------------------------------------------------------------------

def test_the_batched_steps_record_their_stages():
    _run_visual(_visual_frames())
    _run_sort(_sort_frames())
    s = profiling.summary()
    spans = s["spans"]
    assert spans["batched_visual_step"]["calls"] == 4
    assert spans["batched_sort_step"]["calls"] == 4
    for name in VISUAL_STAGES:
        assert spans[name]["calls"] == 4, name
        assert spans[name]["parent"] == "batched_visual_step", name
    for name in SORT_STAGES:
        assert spans[name]["calls"] == 4, name
        assert spans[name]["parent"] == "batched_sort_step", name
    # every auction round is counted, and every check after the unrolled
    # rounds is a wait inside the step; so is each scalar write of
    # `merge.written` (one in each step's state write; the visual step's
    # votes and BestFit wait for nothing)
    auctions = 2 * 4  # one a step
    rounds = s["counts"]["auction.rounds"]
    assert rounds >= auctions * asg.UNROLLED_ROUNDS
    checks = s["waits"]["auction.converged"]["syncs"]
    assert checks == rounds - 2 * auctions
    assert s["waits"]["merge.written"]["syncs"] == 2 * 4
    assert set(s["waits"]) == {"auction.converged", "merge.written"}
    assert spans["visual_step.best_fit"]["syncs"] == 0
    assert (spans["batched_visual_step"]["syncs"]
            + spans["batched_sort_step"]["syncs"]) == checks + 2 * 4
    for name in ("batched_visual_step", "batched_sort_step"):
        assert 0 < spans[name]["wait_ns"] < spans[name]["ns"]


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function created with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _run_visual(_visual_frames()[:1])
    _run_sort(_sort_frames()[:1])
    spans = profiling.summary()["spans"]
    assert spans["batched_visual_step"]["calls"] == 1
    assert spans["batched_sort_step"]["calls"] == 1


def _cpu_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CPU]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_the_profile_holds_the_spans_nested_under_the_caller():
    frames, sframes = _visual_frames(2), _sort_frames(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            _run_visual(frames)
            _run_sort(sframes)
    events = _cpu_events(prof)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    (caller,) = by_name["caller"]
    steps = {n: by_name[n] for n in ("batched_visual_step",
                                     "batched_sort_step")}
    assert all(len(v) == 2 for v in steps.values())
    for name, stages in (("batched_visual_step", VISUAL_STAGES),
                         ("batched_sort_step", SORT_STAGES)):
        for step in steps[name]:
            assert _inside(step, caller)
        for stage in stages:
            assert len(by_name[stage]) == 2, stage
            assert all(any(_inside(e, step) for step in steps[name])
                       for e in by_name[stage]), stage
    for e in by_name["auction.converged"]:
        assert any(_inside(e, a) for a in by_name["visual_step.auction"]
                   + by_name["sort_step.auction"])


def test_steps_are_bit_identical_with_and_without_a_profiler():
    frames, sframes = _visual_frames(), _sort_frames()
    plain = (_run_visual(frames), _run_sort(sframes))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = (_run_visual(frames), _run_sort(sframes))
    _assert_bit_equal(plain, traced)


def test_tracing_adds_no_operation_to_the_step(monkeypatch):
    """The step's aten operations are the same with the spans as with
    spans that do nothing: tracing launches, allocates and syncs nothing
    of its own."""
    frames, sframes = _visual_frames(2), _sort_frames(2)

    def ops():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _run_visual(frames)
            _run_sort(sframes)
        names = [e.name for e in _cpu_events(prof)]
        return sorted(n for n in names if n.startswith("aten::"))

    traced = ops()
    monkeypatch.setattr(profiling.span, "__enter__", lambda self: self)
    monkeypatch.setattr(profiling.span, "__exit__", lambda self, *a: False)
    untraced = ops()
    assert traced == untraced


def test_the_auction_counts_every_round_and_a_wait_per_check(monkeypatch):
    """A contested matrix that takes N > 3 rounds: N rounds counted, and
    N - 2 waits (one check after the unrolled rounds, one after each
    round past them)."""
    calls = []
    fb_round = asg._fb_round

    def counted(*args):
        calls.append(1)
        return fb_round(*args)

    monkeypatch.setattr(asg, "_fb_round", counted)
    g = torch.Generator().manual_seed(8)
    w = 0.5 + 0.01 * torch.rand((6, 6), generator=g)
    asg.auction_lap_fallback(w, 0.3)
    n = len(calls)
    assert n > asg.UNROLLED_ROUNDS
    s = profiling.summary()
    assert s["counts"]["auction.rounds"] == n
    assert s["waits"]["auction.converged"]["syncs"] == n - 2


# --------------------------------------------------------------------------
# the fused scan
# --------------------------------------------------------------------------

def _scan_inputs(steps=8):
    box, conf, valid, feat, fvalid, qual, oa = (
        torch.tensor(x) for x in visual_stream(40, steps, D, F))
    return box, conf, valid, feat, fvalid, qual, oa


def test_the_fused_scan_counts_its_chunks_and_keeps_stats_under_a_profiler():
    inputs = _scan_inputs()
    state = new_visual_state(T, 1, K, F, device="cpu")
    fv.fused_visual_scan(VCFG, state, *inputs, 1, 4)
    s = profiling.summary()
    assert s["spans"]["fused_visual_scan"]["calls"] == 1
    assert s["spans"]["fused_visual_chunk"]["calls"] == 2
    assert s["spans"]["fused_visual_chunk"]["parent"] == "fused_visual_scan"
    assert s["spans"]["fused_visual_chunk"]["syncs"] == 0
    assert s["kept"] == {}
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fv.fused_visual_scan(VCFG, state, *inputs, 1, 4)
    kept = profiling.summary()["kept"]["fused_visual.stats"]
    # the same chunks' stats, from the chunk wrapper itself
    tup, want = fv.state_to_tuple(state), []
    for c0 in (0, 4):
        tup, *o = fv.fused_visual_chunk(
            VCFG, tup, *(x[c0:c0 + 4] for x in inputs), 1 + c0)
        want.append(o[7])
    want = torch.cat(want).sum(0).double().tolist()
    assert kept == {"tensors": 2, "rows": 8, "sum": want}
    assert want[0] >= 8  # an auction round or more a frame


def test_the_fused_scan_is_bit_identical_under_a_profiler():
    inputs = _scan_inputs()
    state = new_visual_state(T, 1, K, F, device="cpu")
    plain = fv.fused_visual_scan(VCFG, map_tensors(torch.clone, state),
                                 *inputs, 1, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fv.fused_visual_scan(VCFG, map_tensors(torch.clone, state),
                                      *inputs, 1, 4)
    _assert_bit_equal(plain, traced)
