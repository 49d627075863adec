"""What every cell shares: finding its files by name, the program's
tracker settings, one profile of a stretch of the window and its reduction
to device time, and the guard against JAX in the process.

A cell of `BENCHMARK.json` names a configuration (`configs/<config>.json`)
and a traffic mix (`mixes/<traffic>.json`); the mix names its driver
(`drivers/<driver>.py`), and every metric is read by
`metrics/<metric name>.py`.  Adding a cell or a metric adds files and
edits none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# compared with the whole top-level name of every module in the process:
# the port's package name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "similari_tpu")
# host calls that launch one kernel each: a profile whose device shows
# another number of kernels than these calls is not whole
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
WINDOW_SPAN = "perfbench.window"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    bench: Dict
    workload: Dict
    config: Dict
    mix: Dict

    @property
    def visual(self) -> bool:
        return self.config["tracker"] == "visualsort"

    def ref_config(self) -> Dict:
        """The configuration as the reference takes it: the mix sets the
        store's capacity."""
        return dict(self.config, capacity=self.mix["capacity"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name, bench, w, load_json(root / conf["file"]),
                load_json(HERE / "mixes" / f"{w['traffic']}.json"))


def load_module(path: Path):
    """The Python file at `path` as a module (metric files carry dots in
    their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(HERE / "drivers" / f"{cell.mix['driver']}.py")


def cell_metrics(cell: Cell, trace: bool) -> List[Dict]:
    """The metrics this cell reports: end-to-end ones with --trace 0,
    per-layer ones with --trace 1; a metric without `workloads` is
    reported where its end-to-end metric is."""
    e2e = cell.bench["end_to_end"]
    mine = {m["name"] for m in e2e
            if cell.name in m.get("workloads", [cell.name])}
    if not trace:
        return [m for m in e2e if m["name"] in mine]
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            or ("workloads" not in m and m["moves"] in mine)]


def read_metrics(cell: Cell, trace: bool, run: Dict) -> Dict[str, Dict]:
    """Each metric's reader on the run's record; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in cell_metrics(cell, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def program_config(cell: Cell):
    """The port's tracker settings object for the configuration."""
    s = cell.config["settings"]
    if cell.visual:
        from similari_tpu_torch.trackers.visual_step import VisualConfig
        return VisualConfig(**s)
    from similari_tpu_torch.trackers.sort_step import SortConfig
    return SortConfig(**s)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def no_gc():
    """The window without the cyclic garbage collector: its passes over
    the objects a run keeps would stall the host at random steps."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


# --------------------------------------------------------------------------
# the profile
# --------------------------------------------------------------------------

@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, CPU and CUDA; the block's extent is
    the span WINDOW_SPAN.  Yields a holder whose `.prof` is the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            torch.cuda.synchronize()
    holder.prof = prof


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


@dataclasses.dataclass
class Profile:
    """A profile reduced to what the readers take; times in seconds."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]  # name -> (device s, launches)
    span_busy_s: Dict[str, float]  # span name -> its device busy s
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def kernel(self, part: str) -> Tuple[float, int]:
        """(device s, launches) of the kernels whose name contains
        `part`."""
        t = n = 0
        for name, (s, c) in self.kernels.items():
            if part in name:
                t, n = t + s, n + c
        return t, n


def reduce_profile(prof, spans: Tuple[str, ...]) -> Profile:
    """Busy time (the union of device intervals) inside the window span,
    device time by kernel, the busy time of each of `spans` (device work
    that starts inside the span, which the drivers end with a
    synchronisation), the top device operations and the longest idle gaps
    with the host operation open across each.  Raises RuntimeError when the
    profile is not whole."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type != DeviceType.CUDA]
    spans_here = {e.name for e in cpu if e.name.startswith("perfbench.")}
    # the device-side copies of the host spans are not device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in spans_here
           and not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    launches = [e for e in cpu if e.name.startswith(LAUNCH_CALLS)]
    if not dev or len(kernels) != len(launches):
        raise RuntimeError(
            f"the profile is not whole: {len(kernels)} kernels on the "
            f"device, {len(launches)} launch calls on the host")
    win = [e for e in cpu if e.name == WINDOW_SPAN]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    iv = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in dev if e.time_range.end > w0
                 and e.time_range.start < w1])
    by_name: Dict[str, List[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    kern = {k: (sum(v) / 1e6, len(v)) for k, v in by_name.items()}
    span_iv = {sp: [(e.time_range.start, e.time_range.end) for e in cpu
                    if e.name == sp] for sp in spans}
    span_busy = {}
    for sp, ranges in span_iv.items():
        # the drivers end a measured span with a synchronisation, so the
        # device work it launched starts and ends inside it
        span_busy[sp] = _length(_merge([
            (e.time_range.start, e.time_range.end) for e in dev
            if any(a <= e.time_range.start <= b for a, b in ranges)])) / 1e6
    ops = sorted(((k[:120], v[0]) for k, v in kern.items()),
                 key=lambda x: -x[1])[:10]
    edges = [(w0, w0)] + iv + [(w1, w1)]
    longest = sorted(((b - a, a, b) for (_, a), (b, _)
                      in zip(edges, edges[1:]) if b > a), reverse=True)[:10]
    host = [e for e in cpu if e.name != WINDOW_SPAN
            and not e.name.startswith("cu")]
    gaps = []
    for length, a, b in longest:
        mid = 0.5 * (a + b)
        open_ = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (min(open_, key=lambda e: e.time_range.elapsed_us()).name
                if open_ else "no host operation")
        gaps.append((name[:120], length / 1e6))
    return Profile(
        window_s=(w1 - w0) / 1e6, busy_s=_length(iv) / 1e6, kernels=kern,
        span_busy_s=span_busy,
        device_ops=ops, idle_gaps=gaps)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(count: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}
