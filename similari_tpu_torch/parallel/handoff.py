"""Cross-shard track handoff and merging (mirrors
`similari_tpu/parallel/handoff.py`).

Scenes shard over the ranks of a mesh, each scene's track store on its
rank.  Two rare-event control operations cross shards:

* `track_migration` moves a live track (every column: Kalman state,
  histories, gallery) from one scene to another, where it takes a fresh
  id from the destination scene's counter;
* `track_merge` folds a source track into an existing destination track
  (ReID identity stitching): the destination keeps its own Kalman state
  and box history, takes the quality-top-K union of both galleries, and
  sums lengths and collected counts; the source slot is freed.

The owning rank reads a track's row with a gather; the rows reach every
rank as an `all_reduce(SUM)` to which only the owner contributes (bool and
bf16 ride as int32 and f32, `mesh.all_reduce_sum`); success flags and new
ids ride sums too, so every rank returns the same [M] results.  Only the
owning ranks write, with index writes.  The state is updated in place and
returned: the input state is overwritten, as the JAX package donates it.
Leaves shaped [S, T, ...] are track columns; the per-scene counter
`next_id` [S] is never written from a payload.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..trackers.visual_state import VisualState
from .gallery import stable_topk
from .mesh import Mesh, all_reduce_sum, check_on_mesh

_MERGED = ("feats", "feat_quality", "feat_valid", "collected", "length")


def _track_leaves(state) -> Dict[str, torch.Tensor]:
    """name -> tensor of every [S, T, ...] leaf (Kalman leaves as
    "kf.<field>")."""
    s, t = state.active.shape
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update((f"{f.name}.{g.name}", getattr(v, g.name))
                       for g in dataclasses.fields(v))
        else:
            out[f.name] = v
    return {k: v for k, v in out.items()
            if v.dim() >= 2 and v.shape[:2] == (s, t)}


def _find(state, mesh: Mesh, scene: torch.Tensor, track_id: torch.Tensor):
    """(here [M] bool: this rank holds the active track, local scene [M],
    slot [M]) of each (global scene, id)."""
    s_local = state.active.shape[0]
    here = (scene // s_local) == mesh.shard
    local = (scene % s_local).long()
    hit = ((state.track_id[local] == track_id[:, None])
           & state.active[local] & here[:, None])
    return hit.any(1), local, hit.to(torch.int32).argmax(1)


def _rows(mesh: Mesh, leaves: Dict[str, torch.Tensor], here, local, slot):
    """Each leaf's rows [M, ...] at (local, slot), summed over the ranks
    with zeros from every rank that does not hold them."""
    out = {}
    for name, a in leaves.items():
        r = a[local, slot]
        keep = here.view((-1,) + (1,) * (r.dim() - 1))
        out[name] = all_reduce_sum(mesh, torch.where(keep, r,
                                                     torch.zeros_like(r)))
    return out


def _write(leaves, rows, where, local, slot) -> None:
    """leaves[name][local[m], slot[m]] = rows[name][m] where `where[m]`."""
    m = where.nonzero().squeeze(1)
    for name, r in rows.items():
        a = leaves[name]
        a[local[m], slot[m]] = r[m].to(a.dtype)


def _check(mesh, state, *entries) -> None:
    check_on_mesh(mesh, state.active, *entries)
    if len({e.shape for e in entries}) != 1 or entries[0].dim() != 1:
        raise ValueError("the entries must be [M] tensors of one length")


def track_migration(mesh: Mesh):
    """The migration op for batched `SortState` and `VisualState`:

        state, success, new_ids = migrate(
            state,         # this rank's block of scenes
            src_scene,     # [M] int32 global scene of each move
            src_track_id,  # [M] int32 id of the track to move
            dst_scene,     # [M] int32 global destination scene
            dst_epoch,     # [M] int32 the destination scene's epoch
        )

    A move fails (success False, new id 0, the source untouched) when its
    track is missing or its destination scene has no free slot.  A move's
    rank counts the earlier moves found for the same scene, whether they
    fit or not, and it takes the rank-th free slot and id next_id + rank +
    1; next_id advances by the moves that landed."""

    def migrate(state, src_scene, src_track_id, dst_scene, dst_epoch):
        _check(mesh, state, src_scene, src_track_id, dst_scene, dst_epoch)
        s_local = state.active.shape[0]
        leaves = _track_leaves(state)
        src_here, src_local, src_slot = _find(state, mesh, src_scene,
                                              src_track_id)
        found = all_reduce_sum(mesh, src_here)
        payload = _rows(mesh, leaves, src_here, src_local, src_slot)

        dst_local = (dst_scene % s_local).long()
        mine = (dst_scene // s_local) == mesh.shard
        m = dst_scene.shape[0]
        before = torch.ones((m, m), dtype=torch.bool,
                            device=dst_scene.device).tril(-1)
        same = dst_local[:, None] == dst_local[None, :]
        rank = (before & same & (mine & found)[None, :]).sum(
            1, dtype=torch.int32)
        free = ~state.active
        cap_ok = rank < free.sum(1, dtype=torch.int32)[dst_local]
        landed = mine & found & cap_ok
        success = all_reduce_sum(mesh, landed)
        free_rank = torch.where(free, free.to(torch.int32).cumsum(1) - 1, -1)
        dst_slot = (free_rank[dst_local] == rank[:, None]).to(
            torch.int32).argmax(1)
        new_ids = all_reduce_sum(mesh, torch.where(
            landed, state.next_id[dst_local] + rank + 1, 0).to(torch.int32))
        issued = torch.zeros_like(state.next_id).index_add_(
            0, dst_local, landed.to(state.next_id.dtype))

        payload["track_id"] = new_ids
        payload["last_epoch"] = dst_epoch.to(torch.int32)
        payload["active"] = torch.ones_like(payload["active"])
        _write(leaves, payload, landed, dst_local, dst_slot)
        dead = (src_here & success).nonzero().squeeze(1)
        state.active[src_local[dead], src_slot[dead]] = False
        state.next_id.add_(issued)
        return state, success, new_ids

    return migrate


def track_merge(mesh: Mesh):
    """The merge op for batched `VisualState`:

        state, success = merge(
            state,                      # this rank's block of scenes
            src_scene, src_track_id,    # [M] int32 (global scene, id)
            dst_scene, dst_track_id,    # [M] int32 (global scene, id)
        )

    The destination keeps the top K of both galleries by quality (invalid
    lanes last, ties to the lower lane, the destination's first), and the
    sums of `length` and `collected`; its other columns, `last_epoch` among
    them, stay.  An entry succeeds only if both tracks exist and it is
    independent of the batch's other entries: a duplicated source or
    destination, a chain (one entry's destination is another's source)
    and a self-merge fail and leave the state untouched."""

    def merge(state: VisualState, src_scene, src_id, dst_scene, dst_id):
        _check(mesh, state, src_scene, src_id, dst_scene, dst_id)
        src_here, src_local, src_slot = _find(state, mesh, src_scene, src_id)
        dst_here, dst_local, dst_slot = _find(state, mesh, dst_scene, dst_id)
        src_found = all_reduce_sum(mesh, src_here)
        dst_found = all_reduce_sum(mesh, dst_here)
        eq_d = ((dst_scene[:, None] == dst_scene[None, :])
                & (dst_id[:, None] == dst_id[None, :]))
        eq_s = ((src_scene[:, None] == src_scene[None, :])
                & (src_id[:, None] == src_id[None, :]))
        unique = (eq_d.sum(1) == 1) & (eq_s.sum(1) == 1)
        chain = ((dst_scene[:, None] == src_scene[None, :])
                 & (dst_id[:, None] == src_id[None, :]))
        indep = ~chain.any(1) & ~chain.any(0)
        success = src_found & dst_found & unique & indep

        leaves = {n: a for n, a in _track_leaves(state).items()
                  if n in _MERGED}
        src = _rows(mesh, leaves, src_here, src_local, src_slot)
        dst = _rows(mesh, leaves, dst_here, dst_local, dst_slot)
        k, f = state.feats.shape[-2:]
        cat_q = torch.cat([dst["feat_quality"], src["feat_quality"]], 1)
        cat_v = torch.cat([dst["feat_valid"], src["feat_valid"]], 1)
        cat_f = torch.cat([dst["feats"], src["feats"]], 1)  # [M, 2K, F]
        _, keep = stable_topk(torch.where(cat_v, cat_q, -torch.inf), k)
        merged = {
            "feats": torch.gather(cat_f, 1, keep[..., None].expand(-1, -1, f)),
            "feat_quality": torch.gather(cat_q, 1, keep),
            "feat_valid": torch.gather(cat_v, 1, keep),
            "collected": dst["collected"] + src["collected"],
            "length": dst["length"] + src["length"],
        }
        _write(leaves, merged, success & dst_here, dst_local, dst_slot)
        dead = (src_here & success).nonzero().squeeze(1)
        state.active[src_local[dead], src_slot[dead]] = False
        return state, success

    return merge
