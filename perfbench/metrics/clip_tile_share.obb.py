"""The share of the clip kernel's 32 x 32 tiles that ran the clip (held a
pair in radius), over every tile of its launches in the traced steps: the
kept `clip.tiles_run` over `clip.tiles`, which `ops/clip.py` keeps only
while a profiler records (`perfbench/program_trace.py`), in %.  How
narrow the x-sort keeps each scene's band of in-radius pairs."""

from perfbench import program_trace


def read(run):
    ran = program_trace.kept_column_mean("clip.tiles_run", 0)
    tiles = program_trace.kept_column_mean("clip.tiles", 0)
    if ran is None or not tiles:
        return None
    return 100.0 * ran / tiles
