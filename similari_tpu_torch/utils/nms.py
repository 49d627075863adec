"""`nms()` with the reference's semantics (mirrors
`similari_tpu/utils/nms.py`; the reference's `src/utils/nms.rs:32-72`).

Candidates pass the score threshold and a positive size, are ranked by
score (or box height when the score is None), and run through
`ops/nms.py::nms_kernel` on `device` (None = CUDA, the port's rule for
entry points): oriented frames of 512 boxes or more take the block-skip
route there, the clip kernel.  With `device="cpu"` a frame of at most
`HOST_MAX_BOXES` boxes takes the port's C++ loop (`native.py::nms_host`,
`csrc/nms.cpp`), as the JAX package's `nms()` does for every such frame;
the keeps are the same either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device
from ..ops.nms import nms_kernel
from .bbox import Universal2DBox
from .pad import pad_pow2

HOST_MAX_BOXES = 64  # the JAX package's split for its host C++ loop


def nms(
    detections: Sequence[Tuple[Universal2DBox, Optional[float]]],
    nms_threshold: float,
    score_threshold: Optional[float] = None,
    device: DeviceLike = None,
) -> List[Universal2DBox]:
    """Greedy NMS; rank = score or box height; returns the kept boxes in
    descending rank."""
    dev = resolve_device(device)
    score_threshold = (
        score_threshold if score_threshold is not None
        else float(np.finfo(np.float32).min)
    )
    cands = []
    for bb, score in detections:
        s = score if score is not None else np.float32(np.finfo(np.float32).max)
        if s > score_threshold and bb.height > 0.0 and bb.aspect > 0.0:
            rank = score if score is not None else bb.height
            cands.append((rank, bb))
    if not cands:
        return []
    cands.sort(key=lambda e: -e[0])
    n = len(cands)

    npad = pad_pow2(n)
    boxes = np.zeros((npad, 5), np.float32)
    boxes[:n] = [[bb.xc, bb.yc, bb.angle or 0.0, bb.aspect, bb.height]
                 for _, bb in cands]
    # per-call oriented flag, as the Sort API's: the axis-aligned
    # intersection is exact when no box carries an angle
    oriented = bool((boxes[:, 2] != 0.0).any())
    if dev.type == "cpu" and n <= HOST_MAX_BOXES:
        keep = native.nms_host(boxes[:n], nms_threshold, oriented)
    else:
        valid = torch.arange(npad, device=dev) < n
        keep = nms_kernel(torch.from_numpy(boxes).to(dev), valid,
                          float(nms_threshold), oriented)[:n].tolist()
    return [bb for m, (_, bb) in zip(keep, cands) if m]
