"""Auction rounds a frame in the fused VisualSORT kernel: the first column
of the per-frame `stats` that `fused_visual_scan` keeps while the profiler
records (`fused_visual.stats`), over the frames kept: the traced
sequences (`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.kept_column_mean("fused_visual.stats", 0)
