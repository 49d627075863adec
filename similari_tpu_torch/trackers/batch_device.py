"""Device-batched multi-scene SORT engine (mirrors
`similari_tpu/trackers/batch_device.py`).

All scenes of a BatchSort live as rows of ONE batched `SortState` on the
device, and each `predict(request)` runs one step over the scene axis
(`parallel/mesh.py::batched_sort_step`): the device form of the
reference's voting worker threads (`sort/batch_api.rs:35-317`).

Rows of scenes absent from a request step with no valid detection at
epoch 0, so they write nothing.  Track ids come from one global counter:
each scene of a request reserves one id per detection (`base`, then
`base += len(dets)`), so unmatched reservations leave gaps, as the JAX
engine's do.  All scenes share one capacity, doubled before a request
that could overflow the fullest scene.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import batched_sort_step, new_batched_state
from ..utils.bbox import Universal2DBox
from ..utils.pad import pad_pow2
from .sort import (SortTrack, WastedSortTrack, fetch, idle_tracks_of,
                   to_device, track_list, wasted_fields)
from .sort_step import SortConfig
from .state import grow_state, map_tensors, pad_rows
from .waste import build_wasted_records


class BatchEngineBase:
    """Scene rows, epochs, capacity, waste and idle tracks of a batched
    store.  A subclass gives `_new_states(s, t)`, `_grow(state, t)`,
    `_wasted_cls` and `predict_scenes`."""

    _wasted_cls = WastedSortTrack

    def __init__(self, max_idle_epochs: int, history: int, capacity: int,
                 scene_capacity: int, device: DeviceLike):
        self.device = resolve_device(device)
        self.max_idle = max_idle_epochs
        self.history = history
        self.T = capacity
        self.S = scene_capacity
        self.state = self._new_states(self.S, self.T)
        self.row_of_scene: Dict[int, int] = {}
        self.custom_ids = np.full((self.S, self.T), -1, np.int64)
        self.has_custom = np.zeros((self.S, self.T), bool)
        self.active_count = np.zeros((self.S,), np.int64)
        self.epochs: Dict[int, int] = {}
        self.next_track_id = 0
        self.oriented = False

    # ------------------------------------------------------------ capacity
    def _grow_scenes(self, new_s: int):
        self.state = map_tensors(lambda a: pad_rows(a, new_s - self.S),
                                 self.state)
        if hasattr(self.state, "voting_type"):  # keep the -1 sentinel
            self.state.voting_type[self.S:] = -1
        self.custom_ids = np.pad(self.custom_ids,
                                 ((0, new_s - self.S), (0, 0)),
                                 constant_values=-1)
        self.has_custom = np.pad(self.has_custom,
                                 ((0, new_s - self.S), (0, 0)))
        self.active_count = np.pad(self.active_count, (0, new_s - self.S))
        self.S = new_s

    def _ensure_scene(self, scene_id: int) -> int:
        row = self.row_of_scene.get(scene_id)
        if row is not None:
            return row
        row = len(self.row_of_scene)
        if row >= self.S:
            self._grow_scenes(self.S * 2)
        self.row_of_scene[scene_id] = row
        return row

    def _ensure_capacity(self, min_t: int):
        if min_t <= self.T:
            return
        new_t = self.T
        while new_t < min_t:
            new_t *= 2
        self.state = self._grow(self.state, new_t)
        self.custom_ids = np.pad(self.custom_ids,
                                 ((0, 0), (0, new_t - self.T)),
                                 constant_values=-1)
        self.has_custom = np.pad(self.has_custom,
                                 ((0, 0), (0, new_t - self.T)))
        self.T = new_t

    def _begin(self, batch: Dict[int, list]):
        """Rows for the request's scenes; returns (dpad, epochs [S],
        next ids [S]) as numpy, or None for a request without detections
        (its scenes' epochs still advance)."""
        scenes = list(batch)
        for sid in scenes:
            self._ensure_scene(sid)
        dmax = max((len(v) for v in batch.values()), default=0)
        if dmax == 0:
            for sid in scenes:
                self.epochs[sid] = self.epochs.get(sid, 0) + 1
            return None
        self._ensure_capacity(int(self.active_count.max(initial=0)) + dmax)
        epochs = np.zeros((self.S,), np.int32)
        next_ids = np.zeros((self.S,), np.int32)
        base = self.next_track_id
        for sid in scenes:
            row = self.row_of_scene[sid]
            e = self.epochs.get(sid, 0) + 1
            self.epochs[sid] = e
            epochs[row] = e
            next_ids[row] = base
            base += len(batch[sid])  # one id per detection (upper bound)
        self.next_track_id = base
        return pad_pow2(dmax), epochs, next_ids

    def _step_inputs(self, epochs, next_ids):
        """(epochs int[S], the state with next ids [S]) on the device."""
        both = torch.from_numpy(np.stack([epochs, next_ids])).to(self.device)
        return both[0], dataclasses.replace(self.state, next_id=both[1])

    def _finish(self, batch, epochs, box, conf, out, customs_of, voting):
        """Per-scene SortTrack lists from one copy of the step's outputs;
        updates the active counts and custom ids."""
        slot, track_id, is_new, length, pred_box, vt, overflow = fetch(
            out.slot, out.track_id, out.is_new, out.length, out.pred_box,
            voting, out.overflow[:, None].expand(out.slot.shape))
        if overflow.any():
            raise RuntimeError("track store overflow (grow capacity)")
        results: Dict[int, List[SortTrack]] = {}
        for sid, items in batch.items():
            row = self.row_of_scene[sid]
            n = len(items)
            self.active_count[row] += int(is_new[row, :n].sum())
            customs = customs_of(items)
            sl = slot[row, :n].tolist()
            for s, cid in zip(sl, customs):
                self.custom_ids[row, s] = -1 if cid is None else cid
                self.has_custom[row, s] = cid is not None
            results[sid] = track_list(
                sid, int(epochs[row]), track_id[row, :n], pred_box[row, :n],
                box[row, :n], conf[row, :n], length[row, :n],
                np.where(is_new[row, :n], 1, vt[row, :n]), customs)
        return results

    # --------------------------------------------------------------- waste
    def _cur_epochs(self) -> torch.Tensor:
        cur = np.zeros((self.S,), np.int32)
        for sid, row in self.row_of_scene.items():
            cur[row] = self.epochs.get(sid, 0)
        return torch.from_numpy(cur).to(self.device)

    def collect_wasted(self) -> List:
        st = self.state
        cur = self._cur_epochs()
        mask = st.active & (st.last_epoch + self.max_idle < cur[:, None])
        rows, slots = mask.nonzero(as_tuple=True)
        if rows.numel() == 0:
            return []
        (r, sl), host, extra = wasted_fields(st, (rows, slots))
        st.active[rows, slots] = False
        scene_of_row = {row: sid for sid, row in self.row_of_scene.items()}
        out: List = []
        for row in np.unique(r):  # rows in scene order, as the JAX engine
            pick = r == row
            out.extend(build_wasted_records(
                self._wasted_cls, scene_of_row[int(row)], self.history,
                *(h[pick] for h in host),
                **{k: v[pick] for k, v in extra.items()}))
            self.active_count[row] -= int(pick.sum())
            self.has_custom[row, sl[pick]] = False
        return out

    def idle_tracks(self, scene_id: int) -> List[SortTrack]:
        row = self.row_of_scene.get(scene_id)
        if row is None:
            return []
        return idle_tracks_of(
            map_tensors(lambda a: a[row], self.state),
            self.epochs.get(scene_id, 0), scene_id,
            lambda s: (int(self.custom_ids[row, s])
                       if self.has_custom[row, s] else None))

    def total_active(self) -> int:
        return int(self.active_count.sum())


class SceneBatchEngine(BatchEngineBase):
    """Persistent batched SORT store; one step per request."""

    def __init__(self, cfg: SortConfig, history: int, capacity: int = 128,
                 scene_capacity: int = 8, device: DeviceLike = None):
        self.cfg = cfg
        super().__init__(cfg.max_idle_epochs, history, capacity,
                         scene_capacity, device)

    def _new_states(self, s, t):
        return new_batched_state(s, t, self.history, device=self.device)

    @staticmethod
    def _grow(state, t):
        return grow_state(state, t)

    def predict_scenes(
        self,
        batch: Dict[int, List[Tuple[Universal2DBox, Optional[int]]]],
    ) -> Dict[int, List[SortTrack]]:
        begun = self._begin(batch)
        if begun is None:
            return {sid: [] for sid in batch}
        dpad, epochs, next_ids = begun
        s = self.S
        box = np.zeros((s, dpad, 5), np.float32)
        conf = np.zeros((s, dpad), np.float32)
        valid = np.zeros((s, dpad), bool)
        for sid, dets in batch.items():
            row = self.row_of_scene[sid]
            n = len(dets)
            box[row, :n] = [bb.to_vec5() for bb, _ in dets]
            conf[row, :n] = [bb.confidence for bb, _ in dets]
            valid[row, :n] = True
        self.oriented = self.oriented or bool((box[..., 2] != 0).any())

        inputs = to_device(self.device, box, conf, valid)
        ep, state = self._step_inputs(epochs, next_ids)
        step = batched_sort_step(
            dataclasses.replace(self.cfg, oriented=self.oriented))
        self.state, out = step(state, *inputs, ep)
        positional = torch.ones_like(out.slot)
        return self._finish(batch, epochs, box, conf, out,
                            lambda dets: [cid for _, cid in dets], positional)
