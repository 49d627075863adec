"""Cross-shard ReID gallery search (mirrors `similari_tpu/parallel/gallery.py`).

Tracks and their feature galleries live with their scene's shard.  A
global query ("which tracks anywhere match this appearance?") is a
two-level top-k: each rank scores its own galleries, keeps its top k, and
only those [Q, k] candidates ride an `all_gather`; every rank then merges
the n * k candidates into the same global top k.

Top-k order is `jax.lax.top_k`'s: by score, ties lowest index first
(`stable_topk`).  The merge reads the gathered candidates shard-major, so
the n-shard answer equals the one-shard answer over the whole gallery,
ties included: a row's global index is shard * S_local * T * K + its local
index.  Products run in float32 (bf16 galleries upcast exactly, TF32 off)
over fixed blocks of `GALLERY_ROWS` rows, so a row's score does not depend
on how the gallery is split.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.gallery_dots import f32_dots
from ..trackers.visual_state import VisualState
from .mesh import Mesh, all_gather, check_on_mesh

GALLERY_ROWS = 8192  # gallery rows per product; the last block is padded
KINDS = ("cosine", "euclidean")


def stable_topk(scores: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices [Q, k]) of the k largest of each row of f32 scores
    [Q, N] in `jax.lax.top_k`'s order: the float total order (-0.0 below
    0.0), ties lowest index first.  Each entry gets a distinct int64 key,
    its score's ordered bits above its reversed index, so one
    `torch.topk` has no ties to order."""
    x = scores.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    idx = torch.topk(ordered * (1 << 32) + rev, k, dim=-1,
                     sorted=True).indices
    return torch.gather(scores, -1, idx), idx


def _score_rows(feats: torch.Tensor, queries: torch.Tensor,
                kind: str) -> torch.Tensor:
    """f32 [Q, N] similarities of queries [Q, F] against rows [N, F]:
    cosine similarity, or the negative squared euclidean distance."""
    q = queries.float()
    if kind == "cosine":
        q = q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)),
                            min=1e-9)
    else:
        q2 = (q * q).sum(-1)
    n = feats.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, n, GALLERY_ROWS):
        blk = feats[lo:lo + GALLERY_ROWS].float()
        m = blk.shape[0]
        blk = F.pad(blk, (0, 0, 0, GALLERY_ROWS - m))
        if kind == "cosine":
            blk = blk / torch.clamp(
                torch.sqrt((blk * blk).sum(-1, keepdim=True)), min=1e-9)
            s = f32_dots(q, blk)
        else:
            f2 = (blk * blk).sum(-1)
            s = -(q2[:, None] + f2[None, :] - 2.0 * f32_dots(q, blk))
        out[:, lo:lo + m] = s[:, :m]
    return out


def _local_topk_scores(state: VisualState, queries: torch.Tensor, k: int,
                       kind: str):
    """(scores, scene, track_id) [Q, k] of the local top k over every
    gallery lane of a batched state [S, T, K, F]; invalid lanes (not
    collected, or the track inactive) score -inf."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    s, t, g, f = state.feats.shape
    valid = (state.feat_valid & state.active[:, :, None]).reshape(s * t * g)
    scores = _score_rows(state.feats.reshape(s * t * g, f), queries, kind)
    scores = torch.where(valid[None], scores, -torch.inf)
    top, idx = stable_topk(scores, k)
    scene = idx // (t * g)
    slot = (idx // g) % t
    return top, scene.to(torch.int32), state.track_id[scene, slot]


def merge_shard_topk(scores: torch.Tensor, shard: torch.Tensor,
                     scene: torch.Tensor, track: torch.Tensor):
    """The global top k of per-shard candidates [n, Q, k] (stacked in shard
    order) -> (scores, shard, scene, track) [Q, k]."""
    n, q, k = scores.shape

    def flat(a):
        return a.permute(1, 0, 2).reshape(q, n * k)

    top, idx = stable_topk(flat(scores), k)
    return (top, *(torch.gather(flat(a), 1, idx)
                   for a in (shard, scene, track)))


def local_gallery_query(kind: str, k: int, mesh: Mesh):
    """(local_state, queries [Q, F]) -> this rank's (scores, scene, track)
    [Q, k], without the cross-shard merge; scene is the local index."""

    def query(state: VisualState, queries: torch.Tensor):
        check_on_mesh(mesh, state.feats, queries)
        return _local_topk_scores(state, queries, k, kind)

    return query


def global_gallery_query(kind: str, k: int, mesh: Mesh):
    """(local_state, queries [Q, F], the same on every rank) -> (scores,
    shard, scene, track) [Q, k] of the global top k, equal on every rank;
    scene is the index within its shard."""

    def query(state: VisualState, queries: torch.Tensor):
        check_on_mesh(mesh, state.feats, queries)
        scores, scene, track = _local_topk_scores(state, queries, k, kind)
        shard = torch.full_like(scene, mesh.shard)
        return merge_shard_topk(*(all_gather(mesh, a)
                                  for a in (scores, shard, scene, track)))

    return query
