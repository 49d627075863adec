"""Masked row merges and by-slot reads for the SoA track stores (mirrors
the semantics of `similari_tpu/ops/merge.py`).

The JAX package writes rows through one-hot contractions because a vmapped
scatter serialises on the TPU; here they are plain index ops.  A step
writes at most one detection row into each track slot (matched targets
are distinct by assignment, new slots by construction).  Rows that are
not `safe` (padding, or every row of an overflowing frame) never write:
they are sent to a scratch row past the end that is cut off, so a NaN in
an unwritten source row never reaches the state and no host sync is
needed for a boolean mask.

Every function takes an optional leading scene axis: tables [S, T, ...]
with per-detection rows [S, D]; without it, tables are [T, ...] and rows
[D].  Each scene has its own scratch row: `write_index` gives rows of the
flattened [S * (T + 1), ...] view, s * (T + 1) + slot.
"""

from __future__ import annotations

import torch

from ..utils.profiling import wait


def writer_hit(slot: torch.Tensor, safe: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """hit[T, D]: which detection writes each slot (at most one)."""
    t = torch.arange(capacity, dtype=slot.dtype, device=slot.device)
    return (slot[None, :] == t[:, None]) & safe[None, :]


def write_index(slot: torch.Tensor, safe: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """The row of the flattened [S * (T + 1)] view each detection writes:
    its slot in its scene's block, or the scene's scratch row (index
    `capacity` in the block) when it must not write."""
    index = torch.where(safe, slot.long(), capacity)
    if index.dim() == 1:
        return index
    scenes = torch.arange(index.shape[0], device=index.device)
    return index + scenes[:, None] * (capacity + 1)


def written(index: torch.Tensor, capacity: int) -> torch.Tensor:
    """[S?, T] bool: slots that some detection writes."""
    lead = index.shape[:-1]
    n = lead.numel()
    out = torch.zeros(n * (capacity + 1), dtype=torch.bool,
                      device=index.device)
    # on the card, the Python scalar's copy from the host waits for the
    # stream: a sync of the step
    with wait("merge.written"):
        out[index.reshape(-1)] = True
    return out.view(*lead, capacity + 1)[..., :capacity]


def _scene_view(old: torch.Tensor, index: torch.Tensor):
    """(buffer [S, T+1, ...], its flattened [S*(T+1), ...] view); the
    scratch rows are copies of row 0."""
    batched = old if index.dim() == 2 else old[None]
    buf = torch.cat([batched, batched[:, :1]], dim=1)
    return buf, buf.view(-1, *buf.shape[2:])


def _unscene(buf: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    out = buf[:, :-1]
    return out if index.dim() == 2 else out[0]


def merge_rows(old: torch.Tensor, src: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """old[S?, T, ...] with rows src[S?, D, ...] placed at index (see
    write_index)."""
    buf, flat = _scene_view(old, index)
    flat[index.reshape(-1)] = src.reshape(-1, *src.shape[index.dim():]).to(
        old.dtype)
    return _unscene(buf, index)


def merge_ring(old: torch.Tensor, src: torch.Tensor, ring_ix: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """Ring-buffer write old[index[d], ring_ix[d]] = src[d] on
    [S?, T, H, ...]."""
    buf, flat = _scene_view(old, index)
    flat[index.reshape(-1), ring_ix.reshape(-1).long()] = src.reshape(
        -1, *src.shape[index.dim():]).to(old.dtype)
    return _unscene(buf, index)


# gallery-lane writes are the same computation with a lane index per
# detection: old[S?, T, K, F], lane[S?, D]
merge_lane = merge_ring


def take_rows(table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """g[S?, D, ...] = table[S?, slot[d]]."""
    if slot.dim() == 1:
        return table[slot.long()]
    scenes = torch.arange(slot.shape[0], device=slot.device)
    return table[scenes[:, None], slot.long()]


def take_at(matrix: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """g[S?, D] = matrix[S?, d, cols[d]]."""
    return matrix.gather(-1, cols.long()[..., None]).squeeze(-1)


def nth_free_slot(active: torch.Tensor, want_rank: torch.Tensor) -> torch.Tensor:
    """slot[S?, d] = index of the want_rank[d]-th (0-based, slot order)
    free slot of its scene; capacity-1 where there is no such slot.  A
    rank below 0 reads the first entry, as the JAX package's table lookup
    clamps it (such rows are never new, so their slot is never written)."""
    t = active.shape[-1]
    free = ~active
    frank = torch.cumsum(free.long(), -1) - 1  # rank among free slots
    table = torch.full(active.shape[:-1] + (t + 1,), t - 1,
                       dtype=torch.int64, device=active.device)
    slots = torch.arange(t, device=active.device).expand(active.shape)
    table.scatter_(-1, torch.where(free, frank, t), slots)
    return table.gather(-1, torch.clamp(want_rank.long(), 0, t - 1))
