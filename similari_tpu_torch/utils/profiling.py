"""Step timing and profiler traces (mirrors `similari_tpu/utils/profiling.py`).

`StepTimer` keeps a rolling steps/s and scenes/s count; `trace` records a
`torch.profiler` trace of CPU and CUDA activity and writes it as a Chrome
trace (chrome://tracing, Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device


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
    `similari_tpu_torch_trace` in the temporary directory); yields
    `log_dir`.  CUDA activity is recorded on the card (`device=None`,
    raising without one); `device="cpu"` records the CPU only."""
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
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
