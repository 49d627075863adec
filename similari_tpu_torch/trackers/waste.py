"""Shared wasted-track export (a NumPy copy of
`similari_tpu/trackers/waste.py`): unroll a slot's ring history into a
``Wasted*Track`` record (reference waste semantics:
`src/trackers/sort/tracker_api.rs:81-118` — dead tracks leave the store with
their full observed/predicted box history, oldest first).

Four host-side export paths share this builder (``Sort``/``VisualSort`` scene
stores and the ``BatchSort``/``BatchVisualSort`` device engines); the record
class is passed in to keep this module import-free of the tracker APIs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.bbox import Universal2DBox


def build_wasted_records(
    cls,
    scene_id: int,
    history: int,
    hist_obs: np.ndarray,
    hist_pred: np.ndarray,
    hist_conf: np.ndarray,
    length: np.ndarray,
    track_id: np.ndarray,
    last_epoch: np.ndarray,
    hist_feat: Optional[np.ndarray] = None,
    hist_feat_valid: Optional[np.ndarray] = None,
) -> List:
    """Build one record per exported slot.

    All arrays are host (NumPy) slices with a leading per-slot axis; the
    ``hist_*`` rings are ordered oldest→newest by ``(length - n + j) % history``.
    When ``hist_feat``/``hist_feat_valid`` are given the records also carry
    ``observed_features`` (``None`` for frames without a feature).
    """
    out = []
    for k in range(len(length)):
        ln = int(length[k])
        n = min(ln, history)
        order = [(ln - n + j) % history for j in range(n)]
        obs = [
            Universal2DBox.from_vec5(hist_obs[k, o], float(hist_conf[k, o]))
            for o in order
        ]
        pred = [
            Universal2DBox.from_vec5(hist_pred[k, o], float(hist_conf[k, o]))
            for o in order
        ]
        extra = {}
        if hist_feat is not None:
            extra["observed_features"] = [
                hist_feat[k, o].copy() if hist_feat_valid[k, o] else None
                for o in order
            ]
        out.append(
            cls(
                id=int(track_id[k]),
                epoch=int(last_epoch[k]),
                predicted_bbox=pred[-1],
                observed_bbox=obs[-1],
                scene_id=scene_id,
                length=ln,
                predicted_boxes=pred,
                observed_boxes=obs,
                **extra,
            )
        )
    return out
