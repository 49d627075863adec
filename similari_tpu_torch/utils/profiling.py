"""The port's tracing: spans, waits, counters and kept tensors, the step
timer and profiler traces (the timer and `trace` mirror
`similari_tpu/utils/profiling.py`).

`span(name)` times a block on the host clock and, while `torch.profiler`
records, is also a `record_function` range, so the profile holds every
span nested on the same clock as the device's kernels.  `wait(name)` is a
span around a point where the host blocks on the device (a sync); it also
counts the sync at its site.  `count(name, n)` is a plain counter (the
kernel wrappers count their launches), and `keep(name, tensor)` holds a
device tensor while a profiler records, for `summary()` to sum.  None of
them synchronises, launches or allocates on the device.
`device_counter(name, device)` is a counter that a kernel adds to on the
device (the auction kernel's rounds): it is read, with a sync, only where
`counter(name)` or `summary()` is.

Every record lives in this module until `reset()`; `summary()` returns
them as one dict.  The records are kept for one thread: the port steps
its trackers from one.

`StepTimer` keeps a rolling steps/s and scenes/s count; `trace` records a
`torch.profiler` trace of CPU and CUDA activity and writes it as a Chrome
trace (chrome://tracing, Perfetto) into a directory, with `summary()`
beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

from ..device import DeviceLike, resolve_device

# span name -> [calls, host ns, ns of its child spans, ns inside waits
# (its own and its descendants'), syncs (the same), parent name, is a wait]
_SPANS: Dict[str, list] = {}
_COUNTS: Dict[str, int] = {}
# counter name -> device -> int64 tensor whose first element kernels add to
_DEVICE_COUNTS: Dict[str, Dict[torch.device, torch.Tensor]] = {}
_KEPT: Dict[str, List[torch.Tensor]] = {}
_OPEN: List["span"] = []


def recording() -> bool:
    """Whether a profiler records: what a wrapper asks before it makes
    device tensors only for `keep`."""
    return _autograd_profiler._is_profiler_enabled


class span:
    """`with span(name):` times the block (`time.perf_counter_ns`) and adds
    to the name's calls, host ns and self ns (the part no child span
    covers), and to the time and syncs of the waits inside it.  The
    name's parent is the span open around its first call.  While a
    profiler records, the block is also a `record_function(name)`."""

    __slots__ = ("name", "_t0", "_child", "_wait_ns", "_syncs", "_range")
    is_wait = False

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._child = self._wait_ns = self._syncs = 0
        self._range = None
        if recording():
            self._range = record_function(self.name)
            self._range.__enter__()
        _OPEN.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        _OPEN.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.is_wait:
            self._wait_ns += ns
            self._syncs += 1
        parent = _OPEN[-1] if _OPEN else None
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0, 0, 0, 0, 0,
                                       parent and parent.name, self.is_wait]
        rec[0] += 1
        rec[1] += ns
        rec[2] += self._child
        rec[3] += self._wait_ns
        rec[4] += self._syncs
        if parent is not None:
            parent._child += ns
            parent._wait_ns += self._wait_ns
            parent._syncs += self._syncs
        return False


class wait(span):
    """A span around a point where the host blocks on the device: one sync
    counted at its site, its time counted as waiting in every span around
    it."""

    __slots__ = ()
    is_wait = True


def spanned(name: str):
    """A decorator: every call of the function is the span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def device_counter(name: str, device: torch.device,
                   slots: int = 1) -> torch.Tensor:
    """The int64 tensor [slots] on `device` whose first element kernels add
    the counter `name` to (the other slots are the kernel's own, 0 between
    its launches).  Made as zeros on first use after `reset()`; reading
    the counter synchronises with the device."""
    per = _DEVICE_COUNTS.setdefault(name, {})
    t = per.get(device)
    if t is None:
        t = per[device] = torch.zeros(slots, dtype=torch.int64,
                                      device=device)
    return t


def _device_count(name: str) -> int:
    return sum(int(t[0]) for t in _DEVICE_COUNTS.get(name, {}).values())


def counter(name: str) -> int:
    """The counter `name` (0 before its first count), its device part
    included."""
    return _COUNTS.get(name, 0) + _device_count(name)


def keep(name: str, tensor: torch.Tensor) -> None:
    """Hold `tensor` (no copy) under `name` while a profiler records, for
    `summary()` to sum; otherwise do nothing."""
    if recording():
        _KEPT.setdefault(name, []).append(tensor)


def summary() -> Dict:
    """Every record since the last `reset()`:

    - "counts": counter name -> count;
    - "spans": span name -> calls, ns, self_ns, wait_ns (inside waits,
      its own included), syncs, parent;
    - "waits": wait site -> syncs, ns;
    - "kept": name -> tensors, rows (their first dimensions summed) and
      sum (the column sums over every row, as a list).

    Reading the kept tensors and the device counters synchronises with
    the device."""
    spans = {name: dict(calls=r[0], ns=r[1], self_ns=r[1] - r[2],
                        wait_ns=r[3], syncs=r[4], parent=r[5])
             for name, r in _SPANS.items()}
    waits = {name: dict(syncs=r[0], ns=r[1])
             for name, r in _SPANS.items() if r[6]}
    kept = {}
    for name, ts in _KEPT.items():
        total = sum(t.reshape(t.shape[0], -1).sum(0, dtype=torch.float64)
                    for t in ts)
        kept[name] = dict(tensors=len(ts), rows=sum(t.shape[0] for t in ts),
                          sum=total.tolist())
    counts = dict(_COUNTS)
    for name in _DEVICE_COUNTS:
        counts[name] = counts.get(name, 0) + _device_count(name)
    return dict(counts=counts, spans=spans, waits=waits, kept=kept)


def device_events(prof) -> list:
    """The device's own events (kernels, copies, sets) of a finished
    `torch.profiler` profile.  Every `record_function` range, the spans'
    included, has a copy on the device's timeline, flagged
    `is_user_annotation`: it is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def reset() -> None:
    """Clear every counter, span total and kept tensor."""
    _SPANS.clear()
    _COUNTS.clear()
    _KEPT.clear()
    _DEVICE_COUNTS.clear()


class StepTimer:
    """Rolling throughput counter for tracker steps.  A step's time is the
    host's: end the timed block with a synchronisation (a copy back) to
    count the device's work."""

    def __init__(self, window: int = 256):
        self.samples = deque(maxlen=window)
        self.total_steps = 0
        self.total_scenes = 0

    @contextlib.contextmanager
    def step(self, scenes: int = 1):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.samples.append((dt, scenes))
        self.total_steps += 1
        self.total_scenes += scenes

    @property
    def steps_per_sec(self) -> float:
        if not self.samples:
            return 0.0
        t = sum(s[0] for s in self.samples)
        return len(self.samples) / t if t > 0 else 0.0

    @property
    def scenes_per_sec(self) -> float:
        if not self.samples:
            return 0.0
        t = sum(s[0] for s in self.samples)
        n = sum(s[1] for s in self.samples)
        return n / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "steps_per_sec": round(self.steps_per_sec, 2),
            "scenes_per_sec": round(self.scenes_per_sec, 2),
            "total_steps": self.total_steps,
            "total_scenes": self.total_scenes,
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device: DeviceLike = None):
    """Record the block with `torch.profiler` and write a Chrome trace,
    `trace_<pid>_<ns>.json`, into `log_dir` (by default
    `similari_tpu_torch_trace` in the temporary directory), and beside it
    `summary()` at the block's end as `summary_<pid>_<ns>.json`; yields
    `log_dir`.  The port's spans are ranges of the trace.  CUDA activity
    is recorded on the card (`device=None`, raising without one);
    `device="cpu"` records the CPU only."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "similari_tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if len(acts) > 1:
            torch.cuda.synchronize()
    stem = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
    with open(os.path.join(log_dir, f"summary_{stem}.json"), "w") as f:
        json.dump(summary(), f, indent=1)
