"""Frames of every sequence completed in the window, over the window's
seconds (host clock)."""


def read(run):
    if "seq_s" not in run:
        return None
    return run["frames"] / run["window_s"]
