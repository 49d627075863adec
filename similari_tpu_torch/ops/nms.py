"""Batched NMS: rank-ordered greedy suppression on the device (mirrors
`similari_tpu/ops/nms.py`).

The whole pairwise intersection matrix is computed at once, then the
greedy pass runs as a Jacobi fixpoint over the suppression matrix.
"""

from __future__ import annotations

import torch

from . import geometry as geo
from .clip import oriented_inter_blockskip

BLOCK_SKIP_MIN_BOXES = 512  # the block-skip route's auto gate
UNROLLED_ROUNDS = 4
_BIG = 3.0e38


def use_block_skip(block_skip, oriented: bool, neighbors: int, n: int,
                   device: torch.device) -> bool:
    """The route `nms_kernel` takes: None = auto (CUDA, oriented, no top-k
    prune, n >= 512), True/False force."""
    return block_skip is True or (
        block_skip is None and oriented and neighbors == 0
        and n >= BLOCK_SKIP_MIN_BOXES and device.type == "cuda")


def nms_kernel(boxes: torch.Tensor, valid: torch.Tensor,
               nms_threshold: float, oriented: bool = True,
               neighbors: int = -1, block_skip=None) -> torch.Tensor:
    """boxes [N, 5] already in descending rank order; returns keep [N].

    suppress[i, j] (i before j in rank): intersection(i, j) / area(j) >
    threshold, the reference's asymmetric criterion.  `oriented` is static:
    False takes the exact axis-aligned intersection.  `neighbors` > 0 clips
    only each box's `neighbors` nearest in-radius partners
    (`geometry.rotated_intersection_topk`, one more slot for the box
    itself); -1 and 0 mean dense.

    The block-skip route x-sorts the boxes (stable; invalid ones last),
    takes the intersection matrix from the tile-skipping clip kernel
    (`ops/clip.py`), runs the fixpoint in sorted space with the ranks as
    payload, and unsorts only the [N] keep vector.
    """
    n = boxes.shape[0]
    dev = boxes.device
    valid = valid.bool()
    if neighbors < 0:
        neighbors = 0
    rank = torch.arange(n, device=dev)
    perm = None
    if oriented and use_block_skip(block_skip, oriented, neighbors, n, dev):
        key = torch.where(valid, boxes[:, 0], _BIG)
        perm = torch.sort(key, stable=True).indices
        boxes = boxes[perm]
        valid = valid[perm]
        rank = perm
        inter = oriented_inter_blockskip(boxes, boxes)
    elif oriented and 0 < neighbors < n:
        # +1: the self-pair (distance 0) takes one of each row's slots
        inter = geo.rotated_intersection_topk(boxes, boxes,
                                              min(neighbors + 1, n))
    elif oriented:
        inter = geo.rotated_intersection(boxes[:, None, :], boxes[None, :, :])
    else:
        inter = geo.aligned_intersection(boxes[:, None, :], boxes[None, :, :])
    metric = inter / geo.box_area(boxes)[None, :]
    earlier = rank[:, None] < rank[None, :]
    suppress = (earlier & (metric > nms_threshold) & valid[:, None]
                & valid[None, :])

    # greedy keep[i] = valid[i] & no kept earlier j suppressing i, as the
    # fixpoint keep' = valid & ~any_j(keep[j] & suppress[j, i]): each round
    # settles every box whose suppression chain is one longer
    def one(keep):
        return valid & ~(suppress & keep[:, None]).any(dim=0)

    keep = valid
    for _ in range(UNROLLED_ROUNDS):
        keep = one(keep)
    while True:
        nxt = one(keep)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    if perm is not None:
        out = torch.empty_like(keep)
        out[perm] = keep
        keep = out
    return keep
