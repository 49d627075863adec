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
"""

from __future__ import annotations

import torch


def writer_hit(slot: torch.Tensor, safe: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """hit[T, D]: which detection writes each slot (at most one)."""
    t = torch.arange(capacity, dtype=slot.dtype, device=slot.device)
    return (slot[None, :] == t[:, None]) & safe[None, :]


def write_index(slot: torch.Tensor, safe: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """The row each detection writes: its slot, or `capacity` (the scratch
    row) when it must not write."""
    return torch.where(safe, slot.long(), capacity)


def written(index: torch.Tensor, capacity: int) -> torch.Tensor:
    """[T] bool: slots that some detection writes."""
    out = torch.zeros(capacity + 1, dtype=torch.bool, device=index.device)
    out[index] = True
    return out[:capacity]


def merge_rows(old: torch.Tensor, src: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """old[T, ...] with rows src[d] placed at index[d] (see write_index)."""
    t = old.shape[0]
    buf = torch.cat([old, old[:1]])
    buf[index] = src.to(old.dtype)
    return buf[:t]


def merge_ring(old: torch.Tensor, src: torch.Tensor, ring_ix: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """Ring-buffer write old[index[d], ring_ix[d]] = src[d] on [T, H, ...]."""
    t = old.shape[0]
    buf = torch.cat([old, old[:1]])
    buf[index, ring_ix.long()] = src.to(old.dtype)
    return buf[:t]


def take_rows(table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """g[D, ...] = table[slot[d]]."""
    return table[slot.long()]


def take_at(matrix: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """g[D] = matrix[d, cols[d]]."""
    rows = torch.arange(matrix.shape[0], device=matrix.device)
    return matrix[rows, cols.long()]


def nth_free_slot(active: torch.Tensor, want_rank: torch.Tensor) -> torch.Tensor:
    """slot[d] = index of the want_rank[d]-th (0-based, slot order) free
    slot; capacity-1 where there is no such slot.  A rank below 0 reads the
    first entry, as the JAX package's table lookup clamps it (such rows are
    never new, so their slot is never written)."""
    t = active.shape[0]
    free = ~active
    frank = torch.cumsum(free.long(), 0) - 1  # rank among free slots
    table = torch.full((t + 1,), t - 1, dtype=torch.int64,
                       device=active.device)
    table[torch.where(free, frank, t)] = torch.arange(t, device=active.device)
    return table[torch.clamp(want_rank.long(), 0, t - 1)]
