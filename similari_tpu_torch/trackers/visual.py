"""VisualSort — the DeepSORT-like tracker with a ReID feature gallery
(mirrors `similari_tpu/trackers/visual.py`; the reference's
`visual_sort/` pyo3 surface): `VisualSortOptions`, `VisualSortMetricType`,
`VisualSortObservation(Set)`, `VisualSort` and `WastedVisualSortTrack`.

Each scene owns a `VisualState` on the tracker's device, driven by the
general step (`trackers/visual_step.py::visual_step`) under the rules of
`trackers/sort.py` (power-of-two padding, the global id counter, capacity
doubled before a call that could overflow it, one copy back per call).
The feature dimension is fixed by the first feature seen and grows when a
longer one arrives.  `VisualSortOptions.feature_precision("bf16")` keeps
the gallery and feature history in bf16 and rounds the distance inputs to
bf16 (products summed in f32); growth keeps the dtype.

Own-area gates: with `own_area_backend("device")` the device step
computes the shares itself (`ops/ownarea.py`); with "host", and always on
the host engine, they come from the f64 clipping oracle
(`utils/clipping.py`) on every call that has not passed its own.

Engines as in `trackers/sort.py`: "auto" and "device" run the general
step on the tracker's device; "host" keeps numpy leaves for f32 galleries
and runs the port's C++ step (`native.py::VisualStepSession`, one per
scene, dropped wherever the leaves are replaced: a grow of the capacity or
of the feature dimension, the oriented flip, a checkpoint load) on frames
of at most 128 detections, and the NumPy step of
`trackers/host_visual.py` on larger ones, the JAX package's split.  A
bf16 `VisualSort` under "host" runs the device step on the tracker's
device, as the JAX package's does (bf16 is a device storage type).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..device import DeviceLike
from ..utils.bbox import Universal2DBox
from ..utils.clipping import exclusively_owned_areas_normalized_shares
from .constraints import SpatioTemporalConstraints
from .host_visual import host_visual_step_numpy, native_scope
from .sort import (PositionalMetricType, SortTrack, TrackerBase,
                   _SceneStore, check_engine, fetch, padded, to_device,
                   track_list)
from .visual_state import VisualState, grow_visual_state, new_visual_state
from .visual_step import VT_POSITIONAL, VisualConfig, visual_step

F32_MAX = 3.4028235e38
FEATURE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class VisualSortMetricType:
    """`VisualSortMetricType.euclidean(t)` / `.cosine(t)` (`metric.rs:32-57`)."""

    def __init__(self, kind: str, threshold: float):
        self.kind = kind
        self.threshold = threshold

    @staticmethod
    def euclidean(threshold: float = F32_MAX) -> "VisualSortMetricType":
        assert threshold > 0.0, "Threshold must be a positive number"
        return VisualSortMetricType("euclidean", threshold)

    @staticmethod
    def cosine(threshold: float) -> "VisualSortMetricType":
        assert -1.0 <= threshold <= 1.0, "Threshold must lay within [-1.0:1:0]"
        return VisualSortMetricType("cosine", threshold)

    def __repr__(self):
        return f"VisualSortMetricType.{self.kind}({self.threshold})"


class VisualSortOptions:
    """Builder parity with `options.rs:9-205` (defaults `options.rs:194-205`,
    `metric/builder.rs:26-42`)."""

    def __init__(self):
        self._max_idle_epochs = 2
        self._kept_history_length = 10
        self._stc = SpatioTemporalConstraints()
        self._visual_metric = VisualSortMetricType.euclidean(F32_MAX)
        self._positional_metric = PositionalMetricType.iou(0.3)
        self._visual_minimal_track_length = 3
        self._visual_minimal_area = 0.0
        self._visual_minimal_quality_use = 0.0
        self._visual_minimal_quality_collect = 0.0
        self._visual_max_observations = 5
        self._visual_min_votes = 1
        self._own_area_use = 0.0
        self._own_area_collect = 0.0
        self._own_area_backend = "device"
        self._own_area_order = 3
        self._own_area_neighbors = 8
        self._positional_min_confidence = 0.1
        self._kalman_position_weight = 1.0 / 20.0
        self._kalman_velocity_weight = 1.0 / 160.0
        self._feature_precision = "f32"

    def max_idle_epochs(self, n: int):
        self._max_idle_epochs = int(n)
        return self

    def kept_history_length(self, n: int):
        assert n > 0, "History length must be a positive number"
        self._kept_history_length = int(n)
        return self

    def spatio_temporal_constraints(self, c: SpatioTemporalConstraints):
        self._stc = c
        return self

    def visual_metric(self, m: VisualSortMetricType):
        self._visual_metric = m
        return self

    def positional_metric(self, m: PositionalMetricType):
        if m.kind == "iou":
            assert m.threshold and 0.0 < m.threshold < 1.0
        self._positional_metric = m
        return self

    def visual_minimal_track_length(self, n: int):
        assert n > 0
        self._visual_minimal_track_length = int(n)
        return self

    def visual_minimal_area(self, a: float):
        assert a >= 0.0
        self._visual_minimal_area = float(a)
        return self

    def visual_minimal_quality_use(self, q: float):
        assert q >= 0.0
        self._visual_minimal_quality_use = float(q)
        return self

    def visual_minimal_quality_collect(self, q: float):
        assert q >= 0.0
        self._visual_minimal_quality_collect = float(q)
        return self

    def visual_max_observations(self, n: int):
        self._visual_max_observations = int(n)
        return self

    def visual_min_votes(self, n: int):
        self._visual_min_votes = int(n)
        return self

    def visual_minimal_own_area_percentage_use(self, a: float):
        assert 0.0 <= a <= 1.0
        self._own_area_use = float(a)
        return self

    def visual_minimal_own_area_percentage_collect(self, a: float):
        assert 0.0 <= a <= 1.0
        self._own_area_collect = float(a)
        return self

    def positional_min_confidence(self, c: float):
        assert 0.01 <= c <= 1.0
        self._positional_min_confidence = float(c)
        return self

    def kalman_position_weight(self, w: float):
        self._kalman_position_weight = float(w)
        return self

    def kalman_velocity_weight(self, w: float):
        self._kalman_velocity_weight = float(w)
        return self

    def own_area_backend(self, backend: str, order: int = 3, neighbors: int = 8):
        """Where own-area shares are computed: "device" (inside the step,
        ops/ownarea.py) or "host" (the exact f64 oracle,
        utils/clipping.py).  Beyond the reference surface."""
        assert backend in ("device", "host"), backend
        self._own_area_backend = backend
        self._own_area_order = int(order)
        self._own_area_neighbors = int(neighbors)
        return self

    def feature_precision(self, precision: str):
        """"f32" or "bf16": the gallery's storage type and the distance
        inputs' rounding (products summed in f32).  Beyond the reference
        surface, as `VisualConfig.feature_precision`."""
        assert precision in FEATURE_DTYPES, precision
        self._feature_precision = precision
        return self

    def _build_config(self) -> VisualConfig:
        # invariant check, `metric/builder.rs:134-140`
        assert (
            0 < self._visual_min_votes
            and 0 < self._visual_minimal_track_length
            and self._visual_minimal_track_length <= self._visual_max_observations
        ), "Ratios for (visual_min_votes, visual_minimal_track_length, visual_max_observations) are broken"
        return VisualConfig(
            positional_kind=self._positional_metric.kind,
            iou_threshold=self._positional_metric.threshold or 0.3,
            positional_min_confidence=self._positional_min_confidence,
            visual_kind=self._visual_metric.kind,
            visual_threshold=self._visual_metric.threshold,
            visual_minimal_track_length=self._visual_minimal_track_length,
            visual_minimal_area=self._visual_minimal_area,
            visual_minimal_quality_use=self._visual_minimal_quality_use,
            visual_minimal_quality_collect=self._visual_minimal_quality_collect,
            visual_min_votes=self._visual_min_votes,
            own_area_use=self._own_area_use,
            own_area_collect=self._own_area_collect,
            own_area_backend=self._own_area_backend,
            own_area_order=self._own_area_order,
            own_area_neighbors=self._own_area_neighbors,
            max_idle_epochs=self._max_idle_epochs,
            constraints=self._stc.as_tuple(),
            position_weight=self._kalman_position_weight,
            velocity_weight=self._kalman_velocity_weight,
            feature_precision=self._feature_precision,
        )

    def __repr__(self):
        return f"VisualSortOptions({vars(self)})"


class VisualSortObservation:
    """`visual_sort.rs:34-79`: optional ReID feature + quality + bbox + id."""

    def __init__(
        self,
        feature=None,
        feature_quality: Optional[float] = None,
        bounding_box: Universal2DBox = None,
        custom_object_id: Optional[int] = None,
    ):
        assert bounding_box is not None, "bounding_box is required"
        self.feature = None if feature is None else np.asarray(feature, np.float32).ravel()
        self.feature_quality = feature_quality
        self.bounding_box = bounding_box
        self.custom_object_id = custom_object_id


class VisualSortObservationSet:
    def __init__(self):
        self.observations: List[VisualSortObservation] = []

    def add(self, observation: VisualSortObservation):
        self.observations.append(observation)


@dataclasses.dataclass
class WastedVisualSortTrack:
    """`visual_sort.rs:83-144`."""

    id: int
    epoch: int
    predicted_bbox: Universal2DBox
    observed_bbox: Universal2DBox
    scene_id: int
    length: int
    predicted_boxes: List[Universal2DBox]
    observed_boxes: List[Universal2DBox]
    observed_features: List[Optional[np.ndarray]]

    def __repr__(self):
        return (
            f"WastedVisualSortTrack(id={self.id}, epoch={self.epoch},"
            f" scene_id={self.scene_id}, length={self.length})"
        )


def pad_features(a, new_dim: int):
    """Zero-pad the last (feature) axis of a tensor or a numpy array to
    `new_dim`, keeping the dtype."""
    if isinstance(a, np.ndarray):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, new_dim - a.shape[-1])]
        return np.pad(a, widths)
    return torch.nn.functional.pad(a, (0, new_dim - a.shape[-1]))


class _VisualSceneStore(_SceneStore):
    def __init__(self, capacity, history, gallery, feature_dim, feature_dtype,
                 device, host=False):
        super().__init__(capacity, history, device, host)
        self.state: VisualState = self._placed(new_visual_state(
            capacity, history, gallery, feature_dim,
            feature_dtype=feature_dtype, device="cpu" if host else device))

    def grow(self, min_capacity: int):
        self.grow_to(grow_visual_state, min_capacity)

    def grow_feature_dim(self, new_dim: int):
        st = self.state
        if new_dim <= st.feature_dim:
            return
        self.state = dataclasses.replace(
            st, feats=pad_features(st.feats, new_dim),
            hist_feat=pad_features(st.hist_feat, new_dim))
        self.session = None


def own_area_shares_host(det_box: np.ndarray,
                         det_conf: np.ndarray) -> np.ndarray:
    """The f64 oracle's normalized own-area shares of boxes [N, 5], f32."""
    return np.asarray(exclusively_owned_areas_normalized_shares(
        [Universal2DBox.from_vec5(det_box[i], float(det_conf[i]))
         for i in range(len(det_box))]), np.float32)


class VisualSort(TrackerBase):
    _wasted_cls = WastedVisualSortTrack

    def __init__(
        self,
        shards: int = 4,
        opts: Optional[VisualSortOptions] = None,
        *,
        initial_capacity: int = 128,
        assignment_backend: str = "auto",
        engine: str = "auto",
        device: DeviceLike = None,
    ):
        """`shards` is accepted for API compatibility.  engine: "auto" /
        "device" run the general step on `device` (None = CUDA); "host"
        runs the NumPy step for f32 galleries and the device step for bf16
        ones (see the module doc)."""
        check_engine(engine)
        opts = opts or VisualSortOptions()
        super().__init__(opts._max_idle_epochs, initial_capacity, device)
        self._engine = engine
        self._opts = opts
        self._cfg = dataclasses.replace(
            opts._build_config(), assignment=assignment_backend)
        self._history = opts._kept_history_length
        self._gallery = opts._visual_max_observations
        self._feature_dtype = FEATURE_DTYPES[self._cfg.feature_precision]
        self._host = (engine == "host"
                      and self._cfg.feature_precision == "f32")
        self._feature_dim = 0  # lazily fixed at the first feature

    def _get_store(self, scene_id: int) -> _VisualSceneStore:
        if scene_id not in self._scenes:
            self._scenes[scene_id] = _VisualSceneStore(
                self._capacity0, self._history, self._gallery,
                max(self._feature_dim, 1), self._feature_dtype,
                self._device, self._host)
        return self._scenes[scene_id]

    # --------------------------------------------------------------- predict
    def predict(self, observation_set: VisualSortObservationSet) -> List[SortTrack]:
        return self.predict_with_scene(0, observation_set)

    def predict_with_scene(
        self, scene_id: int, observation_set: VisualSortObservationSet
    ) -> List[SortTrack]:
        observations = observation_set.observations
        if not observations:
            self._tick_auto_waste()
            self._next_epoch(scene_id)
            return []

        d = len(observations)
        feat_dim = max(
            [self._feature_dim, 1]
            + [len(o.feature) for o in observations if o.feature is not None])
        box = np.zeros((d, 5), np.float32)
        conf = np.zeros((d,), np.float32)
        feat = np.zeros((d, feat_dim), np.float32)
        feat_valid = np.zeros((d,), bool)
        quality = np.zeros((d,), np.float32)
        customs: List[Optional[int]] = []
        for i, o in enumerate(observations):
            box[i] = o.bounding_box.to_vec5()
            conf[i] = o.bounding_box.confidence
            quality[i] = 1.0 if o.feature_quality is None else o.feature_quality
            if o.feature is not None:
                feat[i, : len(o.feature)] = o.feature
                feat_valid[i] = True
            customs.append(o.custom_object_id)

        # host shares from the observations' own boxes (`simple_api.rs:111-127`)
        own_area = None
        if (self._cfg.own_area_use + self._cfg.own_area_collect > 0.0
                and self._cfg.own_area_backend == "host"):
            own_area = np.asarray(exclusively_owned_areas_normalized_shares(
                [o.bounding_box for o in observations]), np.float32)

        epoch, track_id, pred_box, length, slot, vt = self.predict_arrays(
            scene_id, box, conf, feat, feat_valid, quality, customs=customs,
            own_area=own_area)

        return track_list(scene_id, epoch, track_id, pred_box, box, conf,
                          length, vt, customs)

    def predict_arrays(
        self,
        scene_id: int,
        det_box: np.ndarray,  # [N, 5] (xc, yc, angle, aspect, height)
        det_conf: np.ndarray,  # [N]
        det_feat: Optional[np.ndarray] = None,  # [N, F] f32 (None = no ReID)
        det_feat_valid: Optional[np.ndarray] = None,  # [N] bool
        det_quality: Optional[np.ndarray] = None,  # [N] (None = 1.0)
        customs: Optional[Sequence[Optional[int]]] = None,
        own_area: Optional[np.ndarray] = None,  # [N] shares (None = computed
        #                                         when a gate is on)
    ):
        """Array fast path mirroring `Sort.predict_arrays`: no
        per-observation Python objects.

        Returns (epoch, track_id [N], pred_box [N, 5], length [N], slot [N],
        voting_type [N]) as numpy arrays, voting_type 0 = Visual,
        1 = Positional (new tracks report Positional, like the reference's
        `SortTrack`).
        """
        self._tick_auto_waste()
        epoch = self._next_epoch(scene_id)
        d = det_box.shape[0]
        if d == 0:
            z = np.zeros((0,), np.int32)
            return epoch, z, np.zeros((0, 5), np.float32), z, z, z

        if det_feat is None:
            det_feat = np.zeros((d, max(self._feature_dim, 1)), np.float32)
            det_feat_valid = np.zeros((d,), bool)
        if det_feat_valid is None:
            det_feat_valid = np.ones((d,), bool)
        if det_quality is None:
            det_quality = np.ones((d,), np.float32)
        feat_dim = max(det_feat.shape[1], self._feature_dim, 1)
        if feat_dim != self._feature_dim:
            self._feature_dim = feat_dim
            for st in self._scenes.values():
                st.grow_feature_dim(feat_dim)
        if det_feat.shape[1] < feat_dim:
            det_feat = np.pad(
                det_feat, ((0, 0), (0, feat_dim - det_feat.shape[1])))

        store = self._get_store(scene_id)
        store.grow(store.active_count + d)
        if not store.oriented and (det_box[:, 2] != 0).any():
            store.oriented = True
            store.session = None  # it bakes the oriented flag

        # own-area shares from the f64 oracle when a gate is on, the caller
        # passed none and the config says "host" or the host engine runs
        # (the device backend computes them inside the device step)
        gating = self._cfg.own_area_use + self._cfg.own_area_collect > 0.0
        if gating and own_area is None and (
                self._host or self._cfg.own_area_backend == "host"):
            own_area = own_area_shares_host(det_box, det_conf)

        if own_area is None:
            own_area = np.ones((d,), np.float32)
        cfg = dataclasses.replace(self._cfg, oriented=store.oriented)
        step = self._step_host if self._host else self._step_device
        slot, track_id, is_new, length, pred_box, vt = step(
            cfg, store, (det_box, det_conf, det_feat, det_feat_valid,
                         det_quality, own_area), epoch)
        store.active_count += int(is_new.sum())
        # new tracks report Positional voting (reference `SortTrack` contract)
        vt = np.where(is_new, np.int32(VT_POSITIONAL), vt)
        if customs is not None:
            store.set_customs(slot, customs)
        return epoch, track_id, pred_box, length, slot, vt

    def _step_host(self, cfg, store, dets, epoch):
        """The native step on the store's numpy leaves, or the NumPy step
        past its scope: (slot, track_id, is_new, length, pred_box,
        voting_type)."""
        if not native_scope(store.state, dets[0].shape[0]):
            state = dataclasses.replace(
                store.state, next_id=np.int32(self._next_track_id))
            store.state, out = host_visual_step_numpy(cfg, state, *dets,
                                                      epoch)
            self._next_track_id = int(store.state.next_id)
            return tuple(out[k] for k in ("slot", "track_id", "is_new",
                                          "length", "pred_box",
                                          "voting_type"))
        if store.session is None:
            store.session = native.VisualStepSession(cfg, store.state)
        nid, slot, track_id, is_new, pred_box, length, vt = \
            store.session.step(*dets, epoch, self._next_track_id)
        store.set_next_id(nid)
        self._next_track_id = nid
        return slot, track_id, is_new, length, pred_box, vt

    def _step_device(self, cfg, store, dets, epoch):
        """The general step on the tracker's device, outputs back in one
        copy: (slot, track_id, is_new, length, pred_box, voting_type)."""
        d = dets[0].shape[0]
        box, conf, feat, fv, quality, oa, valid = padded(*dets)
        dpad = len(valid)
        dev = self._device
        inputs = to_device(dev, box, conf, valid, feat, fv, quality, oa)
        state = dataclasses.replace(store.state, next_id=torch.full(
            (), self._next_track_id, dtype=torch.int32, device=dev))
        state, out = visual_step(cfg, state, *inputs, epoch)
        store.state = state

        slot, track_id, is_new, length, vt, pred_box, overflow, next_id = \
            fetch(out.slot, out.track_id, out.is_new, out.length,
                  out.voting_type, out.pred_box, out.overflow.expand(dpad),
                  state.next_id.expand(dpad))
        if overflow[0]:
            raise RuntimeError(
                f"track store overflow (capacity {store.state.capacity})")
        self._next_track_id = int(next_id[0])
        return (slot[:d], track_id[:d], is_new[:d], length[:d], pred_box[:d],
                vt[:d])

