"""Readers of the port's own records (`similari_tpu_torch/utils/
profiling.py::summary()`): spans, waits, counters and kept tensors, read in
the run's process after the window.  The records cover every call of the
process, the warm-up and the traced stretch included.  A checkout whose
port keeps no such record gives None, and the metric is left out."""

from __future__ import annotations

from typing import Dict, Optional


def summary() -> Optional[Dict]:
    """The port's records, or None when its tracing module has none."""
    try:
        from similari_tpu_torch.utils import profiling
        read = profiling.summary
    except (ImportError, AttributeError):
        return None
    return read()


def span(name: str) -> Optional[Dict]:
    """The totals of the span `name` (calls, ns, self_ns, wait_ns, syncs),
    or None when it never ran."""
    summ = summary()
    rec = summ and summ.get("spans", {}).get(name)
    return rec if rec and rec["calls"] else None


def syncs_per_call(name: str) -> Optional[float]:
    """The host's waits on the device inside the span, per call."""
    rec = span(name)
    return None if rec is None else rec["syncs"] / rec["calls"]


def wait_ms(name: str) -> Optional[float]:
    """The host ms inside waits (`profiling.wait`) in the span, per call."""
    rec = span(name)
    return None if rec is None else rec["wait_ns"] / rec["calls"] / 1e6


def launch_ms(name: str) -> Optional[float]:
    """The span's host ms outside its waits, per call: the host's own work
    of issuing it."""
    rec = span(name)
    return (None if rec is None
            else (rec["ns"] - rec["wait_ns"]) / rec["calls"] / 1e6)


def host_ms(name: str) -> Optional[float]:
    """The span's host ms per call."""
    rec = span(name)
    return None if rec is None else rec["ns"] / rec["calls"] / 1e6


def kept_column_mean(name: str, column: int) -> Optional[float]:
    """The mean of one column over every row of the tensors kept under
    `name` while a profiler recorded, or None when none was kept."""
    summ = summary()
    rec = summ and summ.get("kept", {}).get(name)
    if not rec or not rec["rows"]:
        return None
    return rec["sum"][column] / rec["rows"]
