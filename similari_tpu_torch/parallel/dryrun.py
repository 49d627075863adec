"""A dry run of the sharded paths over a mesh of ranks (the port's twin of
`dryrun_multichip` in the JAX package's `__graft_entry__.py`).

Run it in every rank of a process group of `n_devices` ranks, or alone
for one shard (a world of one rank is built when no group exists):

    torch.distributed.init_process_group("nccl", init_method=...,
                                         world_size=n, rank=r)
    torch.cuda.set_device(r)
    dryrun_multichip(n)                 # or device="cpu" on gloo

It steps tiny batched VisualSORT scenes (two per shard) once through the
sharded step, queries the global gallery, migrates a track from the last
shard to the first and, for an even number of shards, merges two tracks
across the (hosts, devices) pod mesh; it raises AssertionError when a
result is wrong.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike
from ..trackers.visual_step import VisualConfig
from .gallery import global_gallery_query
from .handoff import track_merge, track_migration
from .mesh import (Mesh, all_reduce_sum, new_batched_visual_state, pod_mesh,
                   scene_mesh, shard_batched_state, sharded_visual_step)


def _expect(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _scene_max_id(mesh: Mesh, state, scene: int, active_only: bool) -> int:
    """The largest track id of a global scene (of its active tracks, or of
    every slot), read by its owner and summed over the ranks."""
    s_local = state.active.shape[0]
    best = torch.zeros((), dtype=torch.int32, device=mesh.device)
    if scene // s_local == mesh.shard:
        ids = state.track_id[scene % s_local]
        if active_only:
            ids = torch.where(state.active[scene % s_local], ids, 0)
        best = ids.max()
    return int(all_reduce_sum(mesh, best))


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    mesh = scene_mesh(n_devices, device)
    dev = mesh.device
    cfg = VisualConfig(
        positional_kind="iou",
        visual_kind="cosine",
        visual_threshold=0.3,
        visual_minimal_track_length=1,
        max_idle_epochs=5,
        assignment="auction",
    )
    step = sharded_visual_step(cfg, mesh)

    s, d, t, h, k, f = 2 * n_devices, 4, 16, 2, 3, 32
    state = shard_batched_state(
        new_batched_visual_state(s, t, h, k, f, device=dev), mesh)
    rng = np.random.default_rng(0)
    box = np.zeros((s, d, 5), np.float32)
    box[..., 0] = rng.uniform(0, 500, size=(s, d))
    box[..., 1] = rng.uniform(0, 500, size=(s, d))
    box[..., 3] = 0.5
    box[..., 4] = 10.0
    feat = rng.normal(size=(s, d, f)).astype(np.float32)
    lo = mesh.shard * 2

    def block(a):
        return torch.as_tensor(a[lo:lo + 2], device=dev)

    ones = torch.ones((2, d), dtype=torch.float32, device=dev)
    tru = ones > 0
    state, out, new_tracks = step(
        state, block(box), ones, tru, block(feat), tru, ones, ones,
        torch.ones(2, dtype=torch.int32, device=dev))
    _expect(int(new_tracks) == s * d,
            f"expected {s * d} new tracks, got {int(new_tracks)}")

    # the global gallery query (all_gather of each shard's top k)
    qfn = global_gallery_query("cosine", 4, mesh)
    scores, _, _, _ = qfn(state, torch.as_tensor(feat[0, :1], device=dev))
    _expect(float(scores[0, 0]) > 0.99, "the query missed its own track")

    # a track handoff from the last shard to the first
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    mig = track_migration(mesh)
    first_id = _scene_max_id(mesh, state, s - 1, active_only=False)
    state, ok, _ = mig(state, i32([s - 1]), i32([first_id]), i32([0]),
                       i32([2]))
    _expect(bool(ok[0]), "cross-shard migration failed")

    # an identity merge across the (hosts, devices) pod mesh: the same
    # ranks, so each keeps its block
    if n_devices >= 2 and n_devices % 2 == 0:
        pmesh = pod_mesh(2, n_devices // 2, device)
        src_scene, dst_scene = 1, s - 1  # first host/device -> last
        src_id = _scene_max_id(pmesh, state, src_scene, active_only=True)
        dst_id = _scene_max_id(pmesh, state, dst_scene, active_only=True)
        merge = track_merge(pmesh)
        state, mok = merge(state, i32([src_scene]), i32([src_id]),
                           i32([dst_scene]), i32([dst_id]))
        _expect(bool(mok[0]), "pod-mesh cross-shard merge failed")
        left = torch.zeros((), dtype=torch.bool, device=dev)
        if pmesh.shard == 0:  # scene 1 is shard 0's second scene
            left = (state.active[1] & (state.track_id[1] == src_id)).any()
        _expect(not bool(all_reduce_sum(pmesh, left)),
                "the merged source track should be freed")
