"""Sort — the easy-to-use SORT tracker (mirrors
`similari_tpu/trackers/sort.py`, the reference's `simple_api.rs` surface).

`predict[_with_scene]`, `predict_arrays`, `wasted`, `clear_wasted`,
`idle_tracks[_with_scene]`, `skip_epochs[_for_scene]`,
`current_epoch[_with_scene]`, the shard stats and `set_auto_waste`.

Each scene owns a `SortState`.  A predict call writes the global id
counter into the state, doubles the capacity first when the call could
overflow it, and runs one step.  Epochs, custom object ids and the
wasted-track bin are host bookkeeping.

Engines:

* "auto" and "device" (the port's rule: entry points run on the card)
  keep the state on the tracker's device (`device=None` means CUDA and
  raises without it) and run the general step
  (`trackers/sort_step.py::sort_step`) on detections padded to a power of
  two: oriented IoU at 512 slots and 64 rows or more reaches the clip
  kernel there.  Its outputs come back in one copy.  On the CPU the plain
  versions run.
* "host", the caller's explicit choice, keeps the state as numpy arrays
  and runs the port's C++ SORT step (`native.py::SortStepSession`, one
  per scene, built on the store's leaves), aligned and oriented, per call
  with no device work, as the JAX package's host engine does when its
  library builds.  The session holds raw pointers to the leaves, so the
  store drops it wherever they are replaced: a grow, the oriented flip
  (the session bakes the config), a checkpoint load.

The JAX package's "auto" takes its host engine per call; that engine is
held to the device step id for id, so "auto" differs between the packages
in the engine only, not in the ids.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device
from ..utils.bbox import Universal2DBox
from ..utils.pad import pad_pow2
from .constraints import SpatioTemporalConstraints
from .host_sort import as_tensors, host_grow, state_to_host
from .sort_step import DEFAULT_MINIMAL_SORT_CONFIDENCE, SortConfig, sort_step
from .state import SortState, grow_state, new_sort_state
from .waste import build_wasted_records

DEFAULT_AUTO_WASTE_PERIODICITY = 100  # the reference's `sort.rs:378`
ENGINES = ("auto", "device", "host")


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}: 'auto', 'device' or 'host'")


class VotingType(Enum):
    Visual = 0
    Positional = 1


class PositionalMetricType:
    """`PositionalMetricType.iou(threshold)` / `.maha()` (pyo3 parity)."""

    def __init__(self, kind: str, threshold: Optional[float] = None):
        self.kind = kind
        self.threshold = threshold

    @staticmethod
    def iou(threshold: float = 0.3) -> "PositionalMetricType":
        assert 0.0 < threshold < 1.0, "Threshold must lay between (0.0 and 1.0)"
        return PositionalMetricType("iou", threshold)

    @staticmethod
    def maha() -> "PositionalMetricType":
        return PositionalMetricType("maha")

    def __repr__(self):
        return (
            f"PositionalMetricType.iou({self.threshold})"
            if self.kind == "iou"
            else "PositionalMetricType.maha()"
        )


@dataclasses.dataclass
class SortTrack:
    """Per-epoch track snapshot, the reference's `sort.rs:285-311`."""

    id: int
    epoch: int
    predicted_bbox: Universal2DBox
    observed_bbox: Universal2DBox
    scene_id: int
    length: int
    voting_type: VotingType
    custom_object_id: Optional[int]

    def __repr__(self):
        return (
            f"SortTrack(id={self.id}, epoch={self.epoch}, scene_id={self.scene_id},"
            f" length={self.length}, voting_type={self.voting_type.name},"
            f" custom_object_id={self.custom_object_id},"
            f" predicted_bbox={self.predicted_bbox}, observed_bbox={self.observed_bbox})"
        )


@dataclasses.dataclass
class WastedSortTrack:
    """Dead-track export with histories, the reference's `sort.rs:313-341`."""

    id: int
    epoch: int
    predicted_bbox: Universal2DBox
    observed_bbox: Universal2DBox
    scene_id: int
    length: int
    predicted_boxes: List[Universal2DBox]
    observed_boxes: List[Universal2DBox]

    def __repr__(self):
        return (
            f"WastedSortTrack(id={self.id}, epoch={self.epoch},"
            f" scene_id={self.scene_id}, length={self.length},"
            f" predicted_bbox={self.predicted_bbox}, observed_bbox={self.observed_bbox},"
            f" history={len(self.observed_boxes)})"
        )


# --------------------------------------------------------------------------
# host <-> device transfers shared by the trackers
# --------------------------------------------------------------------------

def to_device(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """numpy arrays with a common leading shape (f32, or bool as 0/1) -> f32,
    bool tensors on `dev` in ONE host-to-device copy: they travel as the
    columns of one f32 array."""
    lead = arrays[0].shape[:-1] if arrays[0].ndim > 1 else arrays[0].shape
    cols = [a.reshape(*lead, -1).astype(np.float32, copy=False)
            for a in arrays]
    packed = torch.from_numpy(np.concatenate(cols, axis=-1)).to(dev)
    out, at = [], 0
    for a, c in zip(arrays, cols):
        x = packed[..., at:at + c.shape[-1]]
        at += c.shape[-1]
        x = x.reshape(a.shape)
        out.append(x > 0 if a.dtype == bool else x.contiguous())
    return out


def fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Tensors with a common leading shape, that of the one of fewest
    dimensions (integer, bool or f32), -> numpy arrays, in ONE
    device-to-host copy: they travel as int32 columns (f32 by its bits)."""
    lead = min((t.shape for t in tensors), key=len)
    cols = []
    for t in tensors:
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        elif t.dtype == torch.float32:
            t = t.contiguous().view(torch.int32)
        elif t.dtype != torch.int32:
            t = t.to(torch.int32)
        cols.append(t.reshape(*lead, -1))
    host = torch.cat(cols, dim=-1).cpu().numpy()
    out, at = [], 0
    for t, c in zip(tensors, cols):
        x = host[..., at:at + c.shape[-1]]
        at += c.shape[-1]
        if t.dtype == torch.float32:
            x = x.view(np.float32)
        elif t.dtype == torch.bool:
            x = x != 0
        out.append(x.reshape(t.shape))
    return out


def padded(*arrays: np.ndarray):
    """The arrays [N, ...] zero-padded to the next power of two of rows,
    so one size bucket reuses one set of shapes, and valid [Dp] last."""
    d = arrays[0].shape[0]
    dpad = pad_pow2(d)
    out = []
    for a in arrays:
        p = np.zeros((dpad,) + a.shape[1:], a.dtype)
        p[:d] = a
        out.append(p)
    valid = np.zeros((dpad,), bool)
    valid[:d] = True
    return out + [valid]


def track_list(scene_id: int, epoch, ids, pred, obs, conf, length, vt,
               customs) -> List[SortTrack]:
    """SortTrack objects from host rows: `epoch` an int or one per track,
    `vt` 0 for Visual voting (the rest Positional)."""
    pb, ob, cf = pred.tolist(), obs.tolist(), conf.tolist()
    ids, length, vt = ids.tolist(), length.tolist(), np.asarray(vt).tolist()
    epochs = (epoch.tolist() if isinstance(epoch, np.ndarray)
              else [epoch] * len(ids))
    return [
        SortTrack(
            id=ids[i],
            epoch=epochs[i],
            predicted_bbox=Universal2DBox.from_vec5(pb[i], cf[i]),
            observed_bbox=Universal2DBox.from_vec5(ob[i], cf[i]),
            scene_id=scene_id,
            length=length[i],
            voting_type=(VotingType.Visual if vt[i] == 0
                         else VotingType.Positional),
            custom_object_id=customs[i],
        )
        for i in range(len(ids))
    ]


def voting_types(state, index) -> torch.Tensor:
    """The stored voting types at `index` (SORT states: all Positional)."""
    if hasattr(state, "voting_type"):
        return state.voting_type[index]
    return torch.ones_like(state.length[index])


def idle_tracks_of(state, cur: int, scene_id: int,
                   custom_of) -> List[SortTrack]:
    """Active tracks of one scene's state not updated at epoch `cur`,
    `sort.rs:185-208`; `custom_of(slot)` gives a slot's custom id."""
    slots = (state.active & (state.last_epoch != cur)).nonzero().squeeze(1)
    if slots.numel() == 0:
        return []
    slot, pred, obs, conf, tid, length, last, vt = fetch(
        slots, state.pred_box[slots], state.obs_box[slots],
        state.conf[slots], state.track_id[slots], state.length[slots],
        state.last_epoch[slots], voting_types(state, slots))
    return track_list(scene_id, last, tid, pred, obs, conf, length, vt,
                      [custom_of(int(s)) for s in slot])


def wasted_fields(state, index):
    """The waste export's rows at `index` (a tuple of index tensors) in one
    copy: (the index as numpy arrays, [hist_obs, hist_pred, hist_conf,
    length, track_id, last_epoch], and for visual states the feature
    history as `build_wasted_records` keywords)."""
    fields = [state.hist_obs[index], state.hist_pred[index],
              state.hist_conf[index], state.length[index],
              state.track_id[index], state.last_epoch[index]]
    visual = hasattr(state, "hist_feat")
    if visual:
        fields += [state.hist_feat[index].float(),
                   state.hist_feat_valid[index]]
    host = fetch(*index, *fields)
    idx, host = host[:len(index)], host[len(index):]
    extra = (dict(hist_feat=host[6], hist_feat_valid=host[7]) if visual
             else {})
    return idx, host[:6], extra


class _SceneStore:
    """The state of one scene and its host bookkeeping.  `host`: the
    state's leaves are numpy arrays (the host engine), else tensors on
    `device`."""

    def __init__(self, capacity: int, history: int, device: torch.device,
                 host: bool = False):
        self.host = host
        self.state: SortState = self._placed(
            new_sort_state(capacity, history,
                           device="cpu" if host else device))
        self.custom_ids = np.full((capacity,), -1, np.int64)
        self.has_custom = np.zeros((capacity,), bool)
        self.active_count = 0
        self.oriented = False  # sticky: flips when a rotated box is seen
        # the host engine's native step on this state's leaves (rebuilt
        # after they are replaced)
        self.session = None

    def _placed(self, state):
        return state_to_host(state) if self.host else state

    def grow_to(self, state_grow, min_capacity: int):
        cap = self.state.capacity
        new_cap = cap
        while new_cap < min_capacity:
            new_cap *= 2
        if new_cap != cap:
            grow = host_grow if self.host else state_grow
            self.state = grow(self.state, new_cap)
            self.session = None
            self.custom_ids = np.concatenate(
                [self.custom_ids, np.full((new_cap - cap,), -1, np.int64)])
            self.has_custom = np.concatenate(
                [self.has_custom, np.zeros((new_cap - cap,), bool)])

    def grow(self, min_capacity: int):
        self.grow_to(grow_state, min_capacity)

    def set_next_id(self, nid: int):
        """The id counter into a host state (the native step advanced
        the leaves in place; a checkpoint reads the counter)."""
        self.state = dataclasses.replace(self.state,
                                         next_id=np.array(nid, np.int32))

    def set_customs(self, slots: np.ndarray,
                    customs: Sequence[Optional[int]]):
        for s, cid in zip(slots.tolist(), customs):
            self.custom_ids[s] = -1 if cid is None else cid
            self.has_custom[s] = cid is not None

    def custom_of(self, slot: int) -> Optional[int]:
        return int(self.custom_ids[slot]) if self.has_custom[slot] else None


class TrackerBase:
    """Epochs, auto-waste, the wasted bin, idle tracks and stats over the
    scene stores of `Sort` and `VisualSort` (whose records are
    `_wasted_cls`)."""

    _wasted_cls = WastedSortTrack

    def __init__(self, max_idle_epochs: int, capacity: int,
                 device: DeviceLike):
        self._device = resolve_device(device)
        self._max_idle = max_idle_epochs
        self._capacity0 = capacity
        self._scenes: Dict[int, _SceneStore] = {}
        self._epochs: Dict[int, int] = {}
        self._wasted_bin: List = []
        self._auto_waste_counter = DEFAULT_AUTO_WASTE_PERIODICITY
        self._auto_waste_periodicity = DEFAULT_AUTO_WASTE_PERIODICITY
        self._next_track_id = 0  # global, like the reference's Sort.track_id

    @property
    def device(self) -> torch.device:
        return self._device

    # ---------------------------------------------------------------- epochs
    def _next_epoch(self, scene_id: int) -> int:
        e = self._epochs.get(scene_id, 0) + 1
        self._epochs[scene_id] = e
        return e

    def skip_epochs(self, n: int):
        self.skip_epochs_for_scene(0, n)

    def skip_epochs_for_scene(self, scene_id: int, n: int):
        """`epoch_db.rs:10-19` + auto-waste (`tracker_api.rs:48-51`)."""
        self._epochs[scene_id] = self._epochs.get(scene_id, 0) + n
        self._auto_waste()

    def current_epoch(self) -> int:
        return self.current_epoch_with_scene(0)

    def current_epoch_with_scene(self, scene_id: int) -> int:
        return self._epochs.get(scene_id, 0)

    def _tick_auto_waste(self):
        if self._auto_waste_counter == 0:
            self._auto_waste()
            self._auto_waste_counter = self._auto_waste_periodicity
        else:
            self._auto_waste_counter -= 1

    def set_auto_waste(self, periodicity: int):
        """`tracker_api.rs:26-31`: change periodicity, trigger on the next
        predict."""
        self._auto_waste_periodicity = periodicity
        self._auto_waste_counter = 0

    # ----------------------------------------------------------------- waste
    def _auto_waste(self):
        """Move dead tracks to the wasted bin, `tracker_api.rs:81-88`."""
        for scene_id, store in self._scenes.items():
            cur = self._epochs.get(scene_id, 0)
            st = as_tensors(store.state)
            mask = st.active & (st.last_epoch + self._max_idle < cur)
            slots = mask.nonzero().squeeze(1)
            if slots.numel():
                self._export_wasted(scene_id, store, slots)

    def _export_wasted(self, scene_id: int, store: _SceneStore,
                       slots: torch.Tensor):
        # a host state's tensor view shares its memory: index_fill_ writes
        # through to the numpy arrays
        st = as_tensors(store.state)
        (sl,), host, extra = wasted_fields(st, (slots,))
        self._wasted_bin.extend(build_wasted_records(
            self._wasted_cls, scene_id, st.history, *host, **extra))
        st.active.index_fill_(0, slots, False)
        store.active_count -= len(sl)
        store.has_custom[sl] = False

    def wasted(self) -> List:
        self._auto_waste()
        out = self._wasted_bin
        self._wasted_bin = []
        return out

    def clear_wasted(self):
        """Drops the wasted bin only (`tracker_api.rs:116-118` clears the
        wasted store without moving eligible tracks out of the main
        store)."""
        self._wasted_bin = []

    # ------------------------------------------------------------------ idle
    def idle_tracks(self) -> List[SortTrack]:
        return self.idle_tracks_with_scene(0)

    def idle_tracks_with_scene(self, scene_id: int) -> List[SortTrack]:
        store = self._scenes.get(scene_id)
        if store is None:
            return []
        return idle_tracks_of(as_tensors(store.state),
                              self._epochs.get(scene_id, 0), scene_id,
                              store.custom_of)

    # ----------------------------------------------------------------- stats
    def shard_stats(self) -> List[int]:
        """Active track count (a single logical shard)."""
        return [sum(s.active_count for s in self._scenes.values())]

    def active_shard_stats(self) -> List[int]:
        return self.shard_stats()

    def wasted_shard_stats(self) -> List[int]:
        return [len(self._wasted_bin)]


class Sort(TrackerBase):
    def __init__(
        self,
        shards: int = 4,
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
        """`shards` is accepted for API compatibility.  engine: "auto" /
        "device" run the general step on `device` (None = CUDA); "host"
        runs the NumPy step with the C++ LAP solver (see the module
        doc)."""
        assert bbox_history > 0
        check_engine(engine)
        super().__init__(max_idle_epochs, initial_capacity, device)
        self._engine = engine
        self._host = engine == "host"
        method = method or PositionalMetricType.maha()
        stc = spatio_temporal_constraints or SpatioTemporalConstraints()
        self._cfg = SortConfig(
            method=method.kind,
            iou_threshold=method.threshold or 0.3,
            min_confidence=min_confidence,
            max_idle_epochs=max_idle_epochs,
            constraints=stc.as_tuple(),
            position_weight=kalman_position_weight,
            velocity_weight=kalman_velocity_weight,
            assignment=assignment_backend,
        )
        self._history = bbox_history

    def _get_store(self, scene_id: int) -> _SceneStore:
        if scene_id not in self._scenes:
            self._scenes[scene_id] = _SceneStore(
                self._capacity0, self._history, self._device, self._host)
        return self._scenes[scene_id]

    # ---------------------------------------------------------------- predict
    def predict(
        self, bboxes: Sequence[Tuple[Universal2DBox, Optional[int]]]
    ) -> List[SortTrack]:
        return self.predict_with_scene(0, bboxes)

    def predict_with_scene(
        self,
        scene_id: int,
        bboxes: Sequence[Tuple[Universal2DBox, Optional[int]]],
    ) -> List[SortTrack]:
        if not bboxes:
            self._tick_auto_waste()
            self._next_epoch(scene_id)
            return []
        d = len(bboxes)
        det_box = np.asarray(
            [[bb.xc, bb.yc, bb.angle or 0.0, bb.aspect, bb.height]
             for bb, _ in bboxes], np.float32)
        det_conf = np.asarray([bb.confidence for bb, _ in bboxes], np.float32)
        customs: List[Optional[int]] = [cid for _, cid in bboxes]

        epoch, track_id, pred_box, length, _slot = self.predict_arrays(
            scene_id, det_box, det_conf, customs)
        return track_list(scene_id, epoch, track_id, pred_box, det_box,
                          det_conf, length, np.ones(d, np.int32), customs)

    def predict_arrays(
        self,
        scene_id: int,
        det_box: np.ndarray,
        det_conf: np.ndarray,
        customs: Optional[Sequence[Optional[int]]] = None,
    ):
        """Array fast path: boxes [N, 5] (xc, yc, angle, aspect, height) and
        conf [N], numpy.  Returns (epoch, track_id [N], pred_box [N, 5],
        length [N], slot [N]) as numpy arrays."""
        self._tick_auto_waste()
        epoch = self._next_epoch(scene_id)
        d = det_box.shape[0]
        store = self._get_store(scene_id)
        store.grow(store.active_count + d)
        if not store.oriented and (det_box[:, 2] != 0).any():
            store.oriented = True
            store.session = None  # it bakes the oriented flag
        cfg = dataclasses.replace(self._cfg, oriented=store.oriented)
        step = self._step_host if self._host else self._step_device
        slot, track_id, is_new, length, pred_box = step(
            cfg, store, det_box, det_conf, epoch)
        store.active_count += int(is_new.sum())
        if customs is not None:
            store.set_customs(slot, customs)
        return epoch, track_id, pred_box, length, slot

    def _step_host(self, cfg, store, det_box, det_conf, epoch):
        """The native step on the store's numpy leaves: (slot, track_id,
        is_new, length, pred_box)."""
        if store.session is None:
            store.session = native.SortStepSession(cfg, store.state)
        nid, slot, track_id, is_new, pred_box, length = store.session.step(
            det_box, det_conf, epoch, self._next_track_id)
        store.set_next_id(nid)
        self._next_track_id = nid
        return slot, track_id, is_new, length, pred_box

    def _step_device(self, cfg, store, det_box, det_conf, epoch):
        """The general step on the tracker's device, outputs back in one
        copy: (slot, track_id, is_new, length, pred_box)."""
        d = det_box.shape[0]
        box, conf, valid = to_device(self._device,
                                     *padded(det_box, det_conf))
        state = dataclasses.replace(store.state, next_id=torch.full(
            (), self._next_track_id, dtype=torch.int32, device=self._device))
        state, out = sort_step(cfg, state, box, conf, valid, epoch)
        store.state = state

        slot, track_id, is_new, length, pred_box, overflow, next_id = fetch(
            out.slot, out.track_id, out.is_new, out.length, out.pred_box,
            out.overflow.expand(box.shape[0]),
            state.next_id.expand(box.shape[0]))
        if overflow[0]:
            raise RuntimeError(
                f"track store overflow (capacity {store.state.capacity})")
        self._next_track_id = int(next_id[0])
        return (slot[:d], track_id[:d], is_new[:d], length[:d],
                pred_box[:d])
