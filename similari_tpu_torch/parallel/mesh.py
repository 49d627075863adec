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

Across cards the scene axis is sharded over the ranks of a
`torch.distributed` process group, which a `Mesh` names (`scene_mesh`,
`pod_mesh`).  Each rank holds its own block of scenes
(`shard_batched_state`) and steps it with the batched code above; the
JAX package's `psum`s become `all_reduce(SUM)` of int32 counts.  CUDA
tensors take the NCCL backend, CPU tensors (`device="cpu"`) gloo.

`batched_sort_step_chunked` / `batched_visual_step_chunked` step the
scene axis in slices one after another, which bounds the [S, D, T]
temporaries of one step.

Each batched step call is one span of `utils/profiling.py`,
`batched_sort_step` or `batched_visual_step` (the in-place form too, its
two merges the child spans `merge_inplace.feats` and
`merge_inplace.hist_feat`), around the step's own stage spans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..ops.merge_inplace import lane_merge_inplace
from ..trackers.sort_step import SortConfig, sort_step
from ..trackers.state import SortState, map_tensors, new_sort_state
from ..trackers.visual_state import VisualState, new_visual_state
from ..trackers.visual_step import (VisualConfig, visual_step,
                                    visual_step_deferred)
from ..utils.profiling import span


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
    (states, StepOutput [S, D, ...]).  `oriented_block_sort` stays as
    configured: oriented IoU above the sorted path's gates ("auto" on
    CUDA) matches every scene on x-sorted views through one clip-kernel
    launch a step (`trackers/sort_step.py::_match_sorted`), where the JAX
    package's vmapped step scores every pair densely."""

    def step(states, det_box, det_conf, det_valid, epochs):
        with span("batched_sort_step"):
            return sort_step(cfg, states, det_box, det_conf, det_valid,
                             epochs)

    return step


def _put_scenes(dst, src, start: int) -> None:
    """dst[start:start + s] = src for every tensor of the dataclasses src
    [s, ...] and dst [S, ...], nested ones included."""
    if dataclasses.is_dataclass(src):
        for f in dataclasses.fields(src):
            _put_scenes(getattr(dst, f.name), getattr(src, f.name), start)
    else:
        dst[start:start + src.shape[0]].copy_(src)


def _chunk_scenes(vstep, chunk: int):
    """`vstep` over the scene axis in slices of `chunk` scenes, one after
    another, each slice's new states and outputs copied into [S, ...]
    results as it ends, so one slice's temporaries are alive at a time.
    S <= chunk calls `vstep` directly; otherwise `chunk` must divide S.
    Each slice steps views of the input states, which the steps never
    write, so no slice sees another's results."""

    def step(states, *args):
        s = states.active.shape[0]
        if s <= chunk:
            return vstep(states, *args)
        if s % chunk:
            raise ValueError(f"{s} scenes are not a multiple of the chunk "
                             f"of {chunk}")
        out = None
        for i in range(0, s, chunk):
            part = vstep(map_tensors(lambda a: a[i:i + chunk], states),
                         *(a[i:i + chunk] for a in args))
            if out is None:
                out = [map_tensors(
                    lambda a: a.new_empty((s,) + a.shape[1:]), p)
                    for p in part]
            for o, p in zip(out, part):
                _put_scenes(o, p, i)
        return tuple(out)

    return step


def batched_sort_step_chunked(cfg: SortConfig, chunk: int):
    """`batched_sort_step` over slices of `chunk` scenes (`_chunk_scenes`)."""
    return _chunk_scenes(batched_sort_step(cfg), chunk)


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
        with span("batched_visual_step"):
            return visual_step(cfg, states, *args)

    return step


def batched_visual_step_chunked(cfg: VisualConfig, chunk: int):
    """`batched_visual_step` over slices of `chunk` scenes
    (`_chunk_scenes`); the in-place form would write into the slices."""
    return _chunk_scenes(batched_visual_step(cfg), chunk)


def batched_visual_step_inplace(cfg: VisualConfig):
    """`batched_visual_step` with the gallery-lane and feature-history
    writes done IN PLACE by the merge kernel, two launches per frame.

    The input states' `feats` and `hist_feat` tensors are overwritten and
    returned inside the new states: a caller that needs the old states
    must copy them first.  Ids, voting types and states equal those of
    `batched_visual_step`."""

    def step(states, *args):
        with span("batched_visual_step"):
            states, out, (src, rowf, maskf, rowh, maskh) = (
                visual_step_deferred(cfg, states, *args))
            s, t, k, f = states.feats.shape
            h = states.hist_feat.shape[2]
            with span("merge_inplace.feats"):
                lane_merge_inplace(states.feats.view(s, t * k, f), src, rowf,
                                   maskf)
            with span("merge_inplace.hist_feat"):
                lane_merge_inplace(states.hist_feat.view(s, t * h, f), src,
                                   rowh, maskh)
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


# --------------------------------------------------------------------------
# meshes of ranks and the sharded steps
# --------------------------------------------------------------------------

SCENE_AXIS = "scenes"
HOST_AXIS = "hosts"
DEVICE_AXIS = "devices"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group laid out as a grid of shards.

    Scenes shard over every axis; rank r holds shard r, the row-major
    linear index over `axis_names` (a pod mesh is the same world seen as
    (hosts, devices)).  `device` is where this rank's tensors live:
    `backend` is "nccl" for a CUDA device and "gloo" for the CPU."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None  # None: the default group

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def shard(self) -> int:
        """This rank's linear shard index."""
        return dist.get_rank(self.group)


def _world(n: int, device: DeviceLike):
    """(device, backend, group) of a mesh of `n` shards over the default
    group's ranks.  With no default group, one shard builds a world of one
    rank; more need `torch.distributed.init_process_group` first.  A
    default group of the other backend is joined by a new group of the
    same ranks."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    group = None
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a mesh of {n} shards needs a process group of "
                             f"{n} ranks; the default group has "
                             f"{dist.get_world_size()}")
        if backend not in dist.get_backend():
            group = dist.new_group(backend=backend)
    elif n == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise RuntimeError(
            f"a mesh of {n} shards needs {n} ranks: call "
            f"torch.distributed.init_process_group(backend={backend!r}, "
            f"world_size={n}, rank=...) in each rank first")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, backend, group


def scene_mesh(n_devices: Optional[int] = None,
               device: DeviceLike = None) -> Mesh:
    """A 1-D mesh of `n_devices` shards (default: every rank of the
    default group, or one rank when there is none)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    dev, backend, group = _world(n_devices, device)
    return Mesh((SCENE_AXIS,), {SCENE_AXIS: n_devices}, dev, backend, group)


def pod_mesh(n_hosts: int, devices_per_host: Optional[int] = None,
             device: DeviceLike = None) -> Mesh:
    """A 2-D (hosts, devices) mesh: the default group's ranks read
    row-major, rank r = host * devices_per_host + device."""
    if devices_per_host is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world % n_hosts:
            raise ValueError(f"{world} ranks do not split over {n_hosts} "
                             "hosts")
        devices_per_host = world // n_hosts
    dev, backend, group = _world(n_hosts * devices_per_host, device)
    return Mesh((HOST_AXIS, DEVICE_AXIS),
                {HOST_AXIS: n_hosts, DEVICE_AXIS: devices_per_host}, dev,
                backend, group)


def check_on_mesh(mesh: Mesh, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor is on the mesh's device type:
    NCCL takes CUDA tensors and gloo, as the mesh uses it, CPU ones."""
    for x in tensors:
        if x.device.type != mesh.device.type:
            raise ValueError(
                f"a {mesh.backend} mesh on {mesh.device} was given a tensor "
                f"on {x.device}; build the mesh with device={x.device.type!r}")


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks, as a new tensor of x's dtype.
    bool and bf16 are summed as int32 (then > 0) and f32: NCCL and gloo
    refuse bool, and a bf16 sum would round."""
    if x.dtype == torch.bool:
        y = x.to(torch.int32)
    elif x.dtype == torch.bfloat16:
        y = x.float()
    else:
        y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group)
    return y > 0 if x.dtype == torch.bool else y.to(x.dtype)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[n_shards, *x.shape]: every rank's `x`, in shard order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.stack(parts)


def _global_count(mesh: Mesh, flags: torch.Tensor) -> torch.Tensor:
    """int32 [] count of the True flags over every rank."""
    return all_reduce_sum(mesh, flags.sum(dtype=torch.int32))


def shard_batched_state(state, mesh: Mesh):
    """This rank's block of a batched state's scene axis, copied onto the
    mesh's device (the JAX package places the global state instead)."""
    s = state.active.shape[0]
    n = mesh.size
    if s % n:
        raise ValueError(f"{s} scenes do not split over {n} shards")
    lo = mesh.shard * (s // n)
    return map_tensors(
        lambda a: a[lo:lo + s // n].to(mesh.device, copy=True), state)


def sharded_sort_step(cfg: SortConfig, mesh: Mesh):
    """The batched SORT step on this rank's scenes: (state, det_box,
    det_conf, det_valid, epochs), each this rank's block -> (state,
    StepOutput, the new-track count over every rank, int32 [])."""
    vstep = batched_sort_step(cfg)

    def step(state, det_box, det_conf, det_valid, epochs):
        check_on_mesh(mesh, state.active, det_box)
        state, out = vstep(state, det_box, det_conf, det_valid, epochs)
        return state, out, _global_count(mesh, out.is_new)

    return step


def sharded_visual_step(cfg: VisualConfig, mesh: Mesh):
    """The batched VisualSORT step on this rank's scenes, its feature
    writes in place (`batched_visual_step_inplace`: the input state is
    overwritten, as the JAX package donates it) -> (state, output, the
    new-track count over every rank)."""
    vstep = batched_visual_step_inplace(cfg)

    def step(state, *args):
        check_on_mesh(mesh, state.active, args[0])
        state, out = vstep(state, *args)
        return state, out, _global_count(mesh, out.is_new)

    return step


def _sharded_tracker_scan(vstep, mesh: Mesh):
    """Frames of this rank's scenes through `vstep`, then one all_reduce
    of both int32 counts: (states, ids [N, S_local, D], new-track count,
    overflow count), the counts over every rank."""

    def scan(states, *streams_and_epochs):
        streams, epochs0 = streams_and_epochs[:-1], streams_and_epochs[-1]
        check_on_mesh(mesh, states.active, *streams)
        epochs0 = torch.as_tensor(epochs0, device=states.device)
        ids, new, ovf = [], [], []
        for i in range(streams[0].shape[0]):
            states, out = vstep(states, *(x[i] for x in streams),
                                epochs0 + i)
            ids.append(out.track_id)
            new.append(out.is_new.sum(dtype=torch.int32))
            ovf.append(out.overflow.sum(dtype=torch.int32))
        counts = all_reduce_sum(mesh, torch.stack(
            [torch.stack(new).sum(dtype=torch.int32),
             torch.stack(ovf).sum(dtype=torch.int32)]))
        return states, torch.stack(ids), counts[0], counts[1]

    return scan


def sharded_sort_scan(cfg: SortConfig, mesh: Mesh):
    """SORT frames of this rank's scenes: (states, det_box [N, S_local,
    D, 5], det_conf, det_valid [N, S_local, D], epochs0 [S_local]) ->
    (states, ids, total_new, total_overflow); any mesh shape."""
    return _sharded_tracker_scan(batched_sort_step(cfg), mesh)


def pod_sharded_sort_scan(cfg: SortConfig, mesh: Mesh):
    """`sharded_sort_scan` (kept for the JAX package's API)."""
    return sharded_sort_scan(cfg, mesh)


def sharded_visual_scan(cfg: VisualConfig, mesh: Mesh):
    """VisualSORT frames of this rank's scenes, streams as
    `batched_visual_scan`'s with the scene axis this rank's block; the
    feature writes in place (`sharded_visual_step`)."""
    return _sharded_tracker_scan(batched_visual_step_inplace(cfg), mesh)
