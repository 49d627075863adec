"""The work of a tracker step, counted from the traffic's shapes and the
tracks alive in each frame, so it reads the same whatever implements the
step.  Every input byte is read once and every output byte written once;
operations are the pairwise metrics the step must score."""

from __future__ import annotations

import numpy as np

IOU_OPS = 15  # per (detection, track) pair: overlap, union, divide, gate
STATE_WORDS = 40  # words of a track's box state (Kalman, boxes, counters)
ROW_WORDS = 8  # words of a detection row without features
OUT_WORDS = 7  # words of a row's outputs


def step_work(valid, alive, visual: bool, feature_dim: int = 0,
              gallery: int = 0):
    """(operations, bytes) of frames whose scenes have `valid` detections
    and `alive` tracks (arrays of one shape: scenes, frames or both)."""
    v = np.asarray(valid, np.float64)
    a = np.asarray(alive, np.float64)
    ops = IOU_OPS * v * a
    words = v * (ROW_WORDS + OUT_WORDS) + a * STATE_WORDS + v * STATE_WORDS
    if visual:
        f, k = feature_dim, gallery
        # each gallery lane against each detection: a dot product of F
        # and the distance from it and the two norms
        ops = ops + v * a * k * (2 * f + 3) + 2 * f * (v + a * k)
        # detection features read, gallery lanes read, a lane and a
        # history row written per detection
        words = words + v * f + a * k * f + 2 * v * f
    return float(ops.sum()), 4.0 * float(words.sum())
