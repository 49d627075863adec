"""The work of the rotated IoU a step needs, counted from the frames'
boxes and the tracks alive in each, so it reads the same whatever
implements the clip.

Only a pair of a valid detection and a live track whose enclosing circles
meet has an area to clip (`too_far`); every other pair is 0 without one.

CLIP_OPS, the floating-point operations of one such pair in the clip's
arithmetic (`similari_tpu_torch/csrc/clip.cu`; divisions, selects and
compares count one each, exact tests none):
  the far test: two differences, two squares and a sum, the radii's sum
      and its square: 7;
  recentring around the pair's midpoint: the two half deltas (2 + 2) and
      the 16 vertex coordinates: 20;
  each of the 8 clipped edges (4 of each quad): its direction (2); against
      each of the 4 half-planes the edge vector (2), the start's side a (5),
      the direction's side b (3), the crossing -a / b (2), the t0 or t1
      update (1) and the same-direction test (3): 64; the two end points
      (8) and their cross product (3): 77 an edge, 616 in all;
  the sum of the 8 terms (7), the area |s| / 2 (2), the union (2) and
      the IoU (1): 12.
  7 + 20 + 616 + 12 = 655.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_OPS = 655
BOX_BYTES = 32  # a box's 8 float32 clip columns, read once
PAIR_BYTES = 4  # an in-radius pair's float32 result, written once


def in_radius_pairs(det_box: torch.Tensor, det_valid: torch.Tensor,
                    trk_box: torch.Tensor, trk_alive: torch.Tensor):
    """(in-radius pairs, valid detections, live tracks), each int64 [S],
    of boxes det_box [S, D, 5] (rows `det_valid`) against trk_box
    [S, T, 5] (slots `trk_alive`), on the boxes' device."""

    def radius(b):
        hw = b[..., 3] * b[..., 4] * 0.5
        hh = b[..., 4] * 0.5
        return torch.sqrt(hw * hw + hh * hh)

    dx = det_box[..., :, None, 0] - trk_box[..., None, :, 0]
    dy = det_box[..., :, None, 1] - trk_box[..., None, :, 1]
    md = radius(det_box)[..., :, None] + radius(trk_box)[..., None, :]
    near = ((dx * dx + dy * dy <= md * md) & det_valid[..., :, None]
            & trk_alive[..., None, :])
    return near.sum((-2, -1)), det_valid.sum(-1), trk_alive.sum(-1)


def clip_work(pairs, valid, alive):
    """(operations, bytes) of the clip over arrays of in-radius pairs,
    valid detections and live tracks."""
    p = float(np.asarray(pairs, np.float64).sum())
    boxes = float(np.asarray(valid, np.float64).sum()
                  + np.asarray(alive, np.float64).sum())
    return CLIP_OPS * p, BOX_BYTES * boxes + PAIR_BYTES * p
