"""Device-batched multi-scene VisualSORT engine (mirrors
`similari_tpu/trackers/batch_visual_device.py`).

The visual form of `batch_device.SceneBatchEngine`: all scenes of a
BatchVisualSort are rows of one batched `VisualState`, and each request
runs one step over the scene axis.  The step is
`parallel/mesh.py::batched_visual_step_inplace`: the gallery lanes and the
feature history are written in place by the merge kernel, two launches per
predict (for CPU tensors its plain version).  Its ids, voting types and
states equal those of the JAX engine's `batched_visual_step`.  Own-area
shares come from the f64 clipping oracle per scene when the options say
`own_area_backend("host")`; with "device" the step computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..device import DeviceLike
from ..parallel.mesh import (batched_visual_step_inplace,
                             new_batched_visual_state)
from ..utils.clipping import exclusively_owned_areas_normalized_shares
from .batch_device import BatchEngineBase
from .sort import SortTrack, to_device
from .visual import (FEATURE_DTYPES, VisualSortObservation,
                     WastedVisualSortTrack, pad_features)
from .visual_state import grow_visual_state
from .visual_step import VisualConfig


class VisualSceneBatchEngine(BatchEngineBase):
    _wasted_cls = WastedVisualSortTrack

    def __init__(self, cfg: VisualConfig, history: int, gallery: int,
                 capacity: int = 128, scene_capacity: int = 8,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.gallery = gallery
        self.F = 1  # grows with the first features
        self.feature_dtype = FEATURE_DTYPES[cfg.feature_precision]
        super().__init__(cfg.max_idle_epochs, history, capacity,
                         scene_capacity, device)

    def _new_states(self, s, t):
        return new_batched_visual_state(
            s, t, self.history, self.gallery, self.F,
            feature_dtype=self.feature_dtype, device=self.device)

    @staticmethod
    def _grow(state, t):
        return grow_visual_state(state, t)

    def _ensure_feature_dim(self, min_f: int):
        if min_f <= self.F:
            return
        self.state = dataclasses.replace(
            self.state, feats=pad_features(self.state.feats, min_f),
            hist_feat=pad_features(self.state.hist_feat, min_f))
        self.F = min_f

    def predict_scenes(
        self, batch: Dict[int, List[VisualSortObservation]]
    ) -> Dict[int, List[SortTrack]]:
        begun = self._begin(batch)
        if begun is None:
            return {sid: [] for sid in batch}
        dpad, epochs, next_ids = begun
        self._ensure_feature_dim(max(
            [self.F] + [len(o.feature) for obs in batch.values() for o in obs
                        if o.feature is not None]))

        host_shares = (
            self.cfg.own_area_use + self.cfg.own_area_collect > 0.0
            and self.cfg.own_area_backend == "host")
        s = self.S
        box = np.zeros((s, dpad, 5), np.float32)
        conf = np.zeros((s, dpad), np.float32)
        valid = np.zeros((s, dpad), bool)
        feat = np.zeros((s, dpad, self.F), np.float32)
        fvalid = np.zeros((s, dpad), bool)
        qual = np.zeros((s, dpad), np.float32)
        oa = np.ones((s, dpad), np.float32)
        for sid, obs in batch.items():
            row = self.row_of_scene[sid]
            n = len(obs)
            if host_shares:
                oa[row, :n] = exclusively_owned_areas_normalized_shares(
                    [o.bounding_box for o in obs])
            box[row, :n] = [o.bounding_box.to_vec5() for o in obs]
            conf[row, :n] = [o.bounding_box.confidence for o in obs]
            valid[row, :n] = True
            qual[row, :n] = [1.0 if o.feature_quality is None
                             else o.feature_quality for o in obs]
            for i, o in enumerate(obs):
                if o.feature is not None:
                    feat[row, i, : len(o.feature)] = o.feature
                    fvalid[row, i] = True
        self.oriented = self.oriented or bool((box[..., 2] != 0).any())

        inputs = to_device(self.device, box, conf, valid, feat, fvalid, qual,
                           oa)
        ep, state = self._step_inputs(epochs, next_ids)
        step = batched_visual_step_inplace(
            dataclasses.replace(self.cfg, oriented=self.oriented))
        self.state, out = step(state, *inputs, ep)
        return self._finish(
            batch, epochs, box, conf, out,
            lambda obs: [o.custom_object_id for o in obs], out.voting_type)
