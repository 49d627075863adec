"""Many scenes on one card (mirrors the single-device part of
`similari_tpu/parallel/mesh.py`).

The JAX package vmaps its per-scene steps; here the scene axis is a
leading tensor dimension of the same step code (`sort_step`,
`visual_step`), so a frame of S scenes costs the launches of one scene,
and every reduction (auction eps, new-track count, overflow, next id,
free-slot ranks) stays per scene: scenes never see each other's data.
States carry the scene axis on every tensor, `next_id` included; epochs
are per scene, int[S].

`batched_visual_step_inplace` writes the two large feature arrays,
gallery lanes [S, T, K, F] and feature history [S, T, H, F], in place with
the merge kernel (`ops/merge_inplace.py`), moving only the rows a frame
writes.

Not ported yet: the sharded (multi-card) steps and meshes, and the
scene-chunked variants (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike
from ..ops.merge_inplace import lane_merge_inplace
from ..trackers.sort_step import SortConfig, sort_step
from ..trackers.state import SortState, map_tensors, new_sort_state
from ..trackers.visual_state import VisualState, new_visual_state
from ..trackers.visual_step import (VisualConfig, visual_step,
                                    visual_step_deferred)


def _stack_scenes(one, n_scenes: int):
    return map_tensors(
        lambda a: a[None].expand((n_scenes,) + a.shape).clone(), one)


def new_batched_state(n_scenes: int, capacity: int, history: int,
                      device: DeviceLike = None) -> SortState:
    """Empty SORT states of `n_scenes` scenes, stacked on a leading axis."""
    return _stack_scenes(new_sort_state(capacity, history, device=device),
                         n_scenes)


def new_batched_visual_state(n_scenes: int, capacity: int, history: int,
                             gallery: int, feature_dim: int,
                             feature_dtype=torch.float32,
                             device: DeviceLike = None) -> VisualState:
    """Empty VisualSORT states of `n_scenes` scenes, stacked."""
    return _stack_scenes(
        new_visual_state(capacity, history, gallery, feature_dim,
                         feature_dtype=feature_dtype, device=device),
        n_scenes)


def batched_sort_step(cfg: SortConfig):
    """The SORT step over a leading scene axis: (states, det_box
    [S, D, 5], det_conf [S, D], det_valid [S, D], epochs int[S]) ->
    (states, StepOutput [S, D, ...]).  The sorted clip-kernel matcher
    works on one scene, so it is turned off here, as in the JAX package."""
    cfg = dataclasses.replace(cfg, oriented_block_sort=False)

    def step(states, det_box, det_conf, det_valid, epochs):
        return sort_step(cfg, states, det_box, det_conf, det_valid, epochs)

    return step


def batched_sort_scan(cfg: SortConfig):
    """Frames of S scenes: (states, det_box [N, S, D, 5], det_conf and
    det_valid [N, S, D], epochs0 int[S]) -> (states, (track_id [N, S, D],
    overflow [N, S])); frame i runs at epochs0 + i."""
    vstep = batched_sort_step(cfg)

    def scan(states, det_box, det_conf, det_valid, epochs0):
        epochs0 = torch.as_tensor(epochs0, device=states.device)
        ids, ovf = [], []
        for i in range(det_box.shape[0]):
            states, out = vstep(states, det_box[i], det_conf[i],
                                det_valid[i], epochs0 + i)
            ids.append(out.track_id)
            ovf.append(out.overflow)
        return states, (torch.stack(ids), torch.stack(ovf))

    return scan


def batched_visual_step(cfg: VisualConfig):
    """The VisualSORT step over a leading scene axis: (states, box, conf,
    valid, feat, feat_valid, quality, own_area, epochs), each input
    [S, D, ...], epochs int[S]."""

    def step(states, *args):
        return visual_step(cfg, states, *args)

    return step


def batched_visual_step_inplace(cfg: VisualConfig):
    """`batched_visual_step` with the gallery-lane and feature-history
    writes done IN PLACE by the merge kernel, two launches per frame.

    The input states' `feats` and `hist_feat` tensors are overwritten and
    returned inside the new states: a caller that needs the old states
    must copy them first.  Ids, voting types and states equal those of
    `batched_visual_step`."""

    def step(states, *args):
        states, out, (src, rowf, maskf, rowh, maskh) = visual_step_deferred(
            cfg, states, *args)
        s, t, k, f = states.feats.shape
        h = states.hist_feat.shape[2]
        lane_merge_inplace(states.feats.view(s, t * k, f), src, rowf, maskf)
        lane_merge_inplace(states.hist_feat.view(s, t * h, f), src, rowh,
                           maskh)
        return states, out

    return step


def batched_visual_scan(cfg: VisualConfig):
    """Frames of S scenes: (states, box [N, S, D, 5], conf, valid, feat,
    feat_valid, quality, own_area [N, S, D(, F)], epochs0 int[S]) ->
    (states, (track_id, voting_type [N, S, D], overflow [N, S]))."""
    vstep = batched_visual_step(cfg)

    def scan(states, box, conf, valid, feat, fvalid, qual, oa, epochs0):
        epochs0 = torch.as_tensor(epochs0, device=states.device)
        ids, vts, ovf = [], [], []
        for i in range(box.shape[0]):
            states, out = vstep(states, box[i], conf[i], valid[i], feat[i],
                                fvalid[i], qual[i], oa[i], epochs0 + i)
            ids.append(out.track_id)
            vts.append(out.voting_type)
            ovf.append(out.overflow)
        return states, (torch.stack(ids), torch.stack(vts), torch.stack(ovf))

    return scan
