"""Readers that several metric files share: a quantity reported under one
name per tracker (`scene_fps.visual`, `scene_fps.sort`, ...), each name
with its own bound, takes its reader from here."""

from __future__ import annotations

import numpy as np

from perfbench import harness, peaks, work


def scene_fps(run):
    """Scene-frames stepped in the window, over the window's seconds (host
    clock): how many camera streams one card keeps tracked (divide by 30
    for 30-frame/s streams)."""
    if "scene_frames" not in run:
        return None
    return run["scene_frames"] / run["window_s"]


def step_p95_ms(run):
    """The 95th percentile of every step in the window, from inputs ready
    on the device to ids in host memory (host clock), in ms."""
    steps = run.get("step_s")
    if not steps:
        return None
    return float(np.percentile(np.asarray(steps) * 1e3, 95))


def step_host_ms(run):
    """The host time of one batched step call, from call to return with no
    synchronisation (the benchmark's own span), median over the window's
    untraced steps, in ms."""
    calls = run.get("call_s")
    if not calls:
        return None
    return float(np.median(calls)) * 1e3


def step_roofline(run, span="perfbench.step"):
    """The least time of the traced steps' work (`perfbench/work.py`: the
    frames' detections and live tracks; float32 peak and HBM peak) over
    the device busy time of the step calls (or of `span`'s), in %."""
    prof = run.get("profile")
    busy = prof and prof.span_busy_s.get(span)
    if not busy or "work" not in run:
        return None
    sh = run["shape"]
    ops = nbytes = 0.0
    for valid, alive in run["work"]:
        o, b = work.step_work(valid, alive, sh["visual"], sh["feature_dim"],
                              sh["gallery"])
        ops, nbytes = ops + o, nbytes + b
    least, bound = peaks.least_time(ops, nbytes)
    harness.log(f"{span}: bound by {bound}; least {least * 1e3:.6f} ms of "
                f"{busy * 1e3:.6f} ms device over {len(run['work'])} steps "
                f"or sequences")
    return 100.0 * least / busy


def idle_share(run):
    """1 - device busy (the union of device intervals) / the traced
    stretch of the window, in %."""
    prof = run.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
