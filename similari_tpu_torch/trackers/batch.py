"""Batch tracker APIs: BatchSort / BatchVisualSort with their request and
result types (mirrors `similari_tpu/trackers/batch.py`; the reference's
`batch.rs`, `sort/batch_api.rs` and `visual_sort/batch_api.rs`).

Engines:

* "auto" and "device": every scene is a row of one batched state on the
  tracker's device (`device=None` means CUDA), and a whole request runs as
  one step over the scene axis (`trackers/batch_device.py`,
  `trackers/batch_visual_device.py`).
* "host": each scene of a request runs through a `Sort` / `VisualSort`
  with engine="host" (`_HostBatchEngine`, `_HostVisualBatchEngine`), the
  reference's per-scene epochs behind its worker threads
  (`sort/batch_api.rs:68-153`), one scene after another.

The JAX package's "auto" takes its host engines; the port's "auto" stays
on the device, as in `trackers/sort.py`.

`distance_shards` / `voting_shards` are accepted for API compatibility.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..device import DeviceLike
from ..utils.bbox import Universal2DBox
from .batch_device import SceneBatchEngine
from .batch_visual_device import VisualSceneBatchEngine
from .constraints import SpatioTemporalConstraints
from .sort import (DEFAULT_AUTO_WASTE_PERIODICITY, PositionalMetricType,
                   Sort, SortTrack, check_engine)
from .sort_step import DEFAULT_MINIMAL_SORT_CONFIDENCE, SortConfig
from .visual import (VisualSort, VisualSortObservation,
                     VisualSortObservationSet, VisualSortOptions)

SceneTracks = Tuple[int, List[SortTrack]]


class _HostBatchEngine:
    """The per-scene host engine of the batch APIs: each scene of a request
    runs through `tracker` (a `Sort` with engine="host"), with the device
    batch engines' surface (`epochs`, `predict_scenes`, `collect_wasted`,
    `idle_tracks`, `total_active`)."""

    def __init__(self, tracker):
        self._tracker = tracker

    @property
    def epochs(self):
        return self._tracker._epochs

    def predict_scenes(self, batch):
        return {scene_id: self._predict_one(scene_id, items)
                for scene_id, items in batch.items()}

    def _predict_one(self, scene_id, items):
        return self._tracker.predict_with_scene(scene_id, items)

    def collect_wasted(self):
        return self._tracker.wasted()

    def idle_tracks(self, scene_id):
        return self._tracker.idle_tracks_with_scene(scene_id)

    def total_active(self):
        return self._tracker.shard_stats()[0]


class _HostVisualBatchEngine(_HostBatchEngine):
    """`_HostBatchEngine` over a `VisualSort` with engine="host"."""

    def _predict_one(self, scene_id, items):
        obs_set = VisualSortObservationSet()
        for o in items:
            obs_set.add(o)
        return self._tracker.predict_with_scene(scene_id, obs_set)


class PredictionBatchResult:
    """Per-scene result stream (`batch.rs:18-38`)."""

    def __init__(self):
        self._queue: deque = deque()
        self._batch_size = 0

    def ready(self) -> bool:
        return len(self._queue) > 0

    def get(self) -> SceneTracks:
        if not self._queue:
            raise RuntimeError("no more batch results pending")
        return self._queue.popleft()

    def batch_size(self) -> int:
        return self._batch_size

    def _push(self, scene_tracks: SceneTracks):
        self._queue.append(scene_tracks)


class _Request:
    """A single-use request: scene id -> its items, and the result."""

    def __init__(self):
        self.batch: Dict[int, list] = {}
        self.result: Optional[PredictionBatchResult] = PredictionBatchResult()

    def _add(self, scene_id: int, item):
        if self.result is None:
            raise RuntimeError(
                "this batch request was already consumed by predict(); "
                f"build a fresh {type(self).__name__} per batch (`batch.rs` "
                "requests are single-use)")
        self.batch.setdefault(scene_id, []).append(item)
        self.result._batch_size = len(self.batch)

    def batch_size(self) -> int:
        return len(self.batch)


class SortPredictionBatchRequest(_Request):
    """`sort/batch_api.rs:339-358`."""

    def add(self, scene_id: int, bbox: Universal2DBox,
            custom_object_id: Optional[int] = None):
        self._add(scene_id, (bbox, custom_object_id))


class VisualSortPredictionBatchRequest(_Request):
    """`visual_sort/batch_api.rs` request flavor."""

    def add(self, scene_id: int, observation: VisualSortObservation):
        self._add(scene_id, observation)


class _BatchTracker:
    """Predict, auto-waste, epochs, waste and idle tracks over a device
    batch engine."""

    def __init__(self, engine):
        self._engine = engine
        self._wasted_bin: List = []
        self._auto_waste_counter = DEFAULT_AUTO_WASTE_PERIODICITY

    def predict(self, batch_request: _Request) -> PredictionBatchResult:
        if self._auto_waste_counter == 0:
            self._auto_waste()
            self._auto_waste_counter = DEFAULT_AUTO_WASTE_PERIODICITY
        else:
            self._auto_waste_counter -= 1
        if batch_request.result is None:
            raise RuntimeError(
                "batch request already consumed by a previous predict(); "
                "build a fresh request per batch")
        result = batch_request.result
        batch_request.result = None
        result._batch_size = len(batch_request.batch)
        for scene_id, tracks in self._engine.predict_scenes(
                batch_request.batch).items():
            result._push((scene_id, tracks))
        return result

    def _auto_waste(self):
        self._wasted_bin.extend(self._engine.collect_wasted())

    def skip_epochs(self, n: int):
        self.skip_epochs_for_scene(0, n)

    def skip_epochs_for_scene(self, scene_id: int, n: int):
        self._engine.epochs[scene_id] = self._engine.epochs.get(scene_id, 0) + n
        self._auto_waste()

    def current_epoch(self) -> int:
        return self.current_epoch_with_scene(0)

    def current_epoch_with_scene(self, scene_id: int) -> int:
        return self._engine.epochs.get(scene_id, 0)

    def wasted(self) -> List:
        self._auto_waste()
        out = self._wasted_bin
        self._wasted_bin = []
        return out

    def clear_wasted(self):
        self._wasted_bin = []

    def idle_tracks(self, scene_id: int = 0) -> List[SortTrack]:
        return self._engine.idle_tracks(scene_id)

    def idle_tracks_with_scene(self, scene_id: int) -> List[SortTrack]:
        return self._engine.idle_tracks(scene_id)

    def shard_stats(self) -> List[int]:
        return [self._engine.total_active()]


class BatchSort(_BatchTracker):
    """Multi-scene SORT (`sort/batch_api.rs:35-317`): on the device-batched
    engine every scene is a row of one batched state, one step per
    request; engine="host" steps each scene on the host."""

    def __init__(
        self,
        distance_shards: int = 4,
        voting_shards: int = 4,
        bbox_history: int = 1,
        max_idle_epochs: int = 5,
        method: Optional[PositionalMetricType] = None,
        min_confidence: float = DEFAULT_MINIMAL_SORT_CONFIDENCE,
        spatio_temporal_constraints: Optional[SpatioTemporalConstraints] = None,
        kalman_position_weight: float = 1.0 / 20.0,
        kalman_velocity_weight: float = 1.0 / 160.0,
        *,
        initial_capacity: int = 128,
        assignment_backend: str = "auto",
        engine: str = "auto",
        device: DeviceLike = None,
    ):
        assert bbox_history > 0
        check_engine(engine)
        method = method or PositionalMetricType.maha()
        stc = spatio_temporal_constraints or SpatioTemporalConstraints()
        if engine == "host":
            super().__init__(_HostBatchEngine(Sort(
                shards=distance_shards, bbox_history=bbox_history,
                max_idle_epochs=max_idle_epochs, method=method,
                min_confidence=min_confidence,
                spatio_temporal_constraints=stc,
                kalman_position_weight=kalman_position_weight,
                kalman_velocity_weight=kalman_velocity_weight,
                initial_capacity=initial_capacity,
                assignment_backend=assignment_backend, engine="host",
                device=device)))
            return
        cfg = SortConfig(
            method=method.kind,
            iou_threshold=method.threshold or 0.3,
            min_confidence=min_confidence,
            max_idle_epochs=max_idle_epochs,
            constraints=stc.as_tuple(),
            position_weight=kalman_position_weight,
            velocity_weight=kalman_velocity_weight,
            assignment=assignment_backend,
        )
        super().__init__(SceneBatchEngine(
            cfg, bbox_history, capacity=initial_capacity, device=device))


class BatchVisualSort(_BatchTracker):
    """Multi-scene VisualSORT (`visual_sort/batch_api.rs:54-335`): on the
    device-batched visual engine one in-place step per request;
    engine="host" steps each scene through a host `VisualSort`."""

    def __init__(
        self,
        distance_shards: int = 4,
        voting_shards: int = 4,
        opts: Optional[VisualSortOptions] = None,
        *,
        initial_capacity: int = 128,
        assignment_backend: str = "auto",
        engine: str = "auto",
        device: DeviceLike = None,
    ):
        check_engine(engine)
        opts = opts or VisualSortOptions()
        if engine == "host":
            super().__init__(_HostVisualBatchEngine(VisualSort(
                distance_shards, opts, initial_capacity=initial_capacity,
                assignment_backend=assignment_backend, engine="host",
                device=device)))
            return
        cfg = dataclasses.replace(opts._build_config(),
                                  assignment=assignment_backend)
        super().__init__(VisualSceneBatchEngine(
            cfg, history=opts._kept_history_length,
            gallery=opts._visual_max_observations,
            capacity=initial_capacity, device=device))
