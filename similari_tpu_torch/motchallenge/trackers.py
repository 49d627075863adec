"""Unified tracker interface for MOTChallenge evaluation (mirrors
`similari_tpu/motchallenge/trackers.py`).

As the reference kit's `python/motchallenge/trackers.py`: trackers consume
per-frame LTWH+conf detections and emit (track_id, l, t, w, h, conf) rows.
They run the port's `Sort` / `VisualSort` on `device` (None = CUDA, as
every entry point of the port; "cpu" runs the plain PyTorch versions).
"""

from __future__ import annotations

from abc import abstractmethod
from typing import List, Tuple

import numpy as np

from ..device import DeviceLike
from ..eval.mot import ltwh_to_vec5, vec5_to_ltwh
from ..trackers import PositionalMetricType, Sort
from ..trackers.visual import (
    VisualSort,
    VisualSortMetricType,
    VisualSortObservation,
    VisualSortObservationSet,
    VisualSortOptions,
)
from ..utils.bbox import BoundingBox


class Tracker:
    @abstractmethod
    def process_frame(
        self, frame_num: int, detections: List[Tuple[float, float, float, float, float]]
    ) -> List[Tuple[int, float, float, float, float, float]]:
        """(left, top, width, height, confidence) ->
        (track_id, left, top, width, height, confidence)"""


def _positional(method: str, iou_threshold: float) -> PositionalMetricType:
    return (PositionalMetricType.iou(iou_threshold) if method == "iou"
            else PositionalMetricType.maha())


class SimilariTPUSort(Tracker):
    def __init__(
        self,
        method: str = "iou",
        iou_threshold: float = 0.3,
        max_idle_epochs: int = 5,
        min_confidence: float = 0.05,
        report_observed: bool = True,
        device: DeviceLike = None,
    ):
        self._tracker = Sort(
            shards=1,
            bbox_history=1,
            max_idle_epochs=max_idle_epochs,
            method=_positional(method, iou_threshold),
            min_confidence=min_confidence,
            device=device,
        )
        self._report_observed = report_observed

    def process_frame(self, frame_num, detections):
        if not detections:
            self._tracker.predict([])
            return []
        dets = np.asarray(detections, np.float32)
        boxes = ltwh_to_vec5(dets)
        confs = np.clip(dets[:, 4], 0.0, 1.0).astype(np.float32)
        _, ids, pred, _, _ = self._tracker.predict_arrays(0, boxes, confs)
        src = boxes if self._report_observed else pred
        ltwh = vec5_to_ltwh(src)
        return [
            (int(ids[i]), *map(float, ltwh[i]), float(confs[i]))
            for i in range(len(ids))
        ]


class SimilariTPUVisualSort(Tracker):
    """VisualSORT over detections with appearance features.

    `features` per frame must align with detections; None disables the
    visual stage for that detection (positional fallback).
    """

    def __init__(
        self,
        method: str = "iou",
        iou_threshold: float = 0.3,
        max_idle_epochs: int = 5,
        visual_threshold: float = 1.0,
        visual_kind: str = "cosine",
        minimal_track_length: int = 2,
        report_observed: bool = True,
        device: DeviceLike = None,
    ):
        vm = (
            VisualSortMetricType.cosine(visual_threshold)
            if visual_kind == "cosine"
            else VisualSortMetricType.euclidean(visual_threshold)
        )
        opts = (
            VisualSortOptions()
            .max_idle_epochs(max_idle_epochs)
            .kept_history_length(1)
            .visual_metric(vm)
            .positional_metric(_positional(method, iou_threshold))
            .visual_minimal_track_length(minimal_track_length)
        )
        self._tracker = VisualSort(1, opts, device=device)
        self._report_observed = report_observed

    def process_frame(self, frame_num, detections, features=None):
        obs = VisualSortObservationSet()
        for i, det in enumerate(detections):
            l, t, w, h, conf = det
            bb = BoundingBox.new_with_confidence(
                l, t, w, h, float(np.clip(conf, 0.0, 1.0))
            ).as_xyaah()
            feat = None if features is None else features[i]
            obs.add(VisualSortObservation(feat, None, bb, None))
        tracks = self._tracker.predict(obs)
        out = []
        for tr in tracks:
            bb = tr.observed_bbox if self._report_observed else tr.predicted_bbox
            ltwh = bb.as_ltwh()
            out.append(
                (tr.id, ltwh.left, ltwh.top, ltwh.width, ltwh.height, bb.confidence)
            )
        return out
