"""Generic voting engines: TopN, BestFit and the SORT LP (mirrors
`similari_tpu/core/voting.py`).

Parity with the reference's `track/voting.rs`, `voting/topn.rs` and
`voting/best.rs`.  `max_dist` is tracked over every record carrying a
feature distance, including ones that fail the threshold filter, exactly
like the reference's filter closure (`topn.rs:78-96`, `best.rs:56-80`).
These run on the host: a query's records are Python objects already.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List

from .track import ObservationMetricOk


@dataclasses.dataclass
class TopNVotingElt:
    """`voting/topn.rs:49-66`."""

    query_track: int
    winner_track: int
    weight: float

    def __eq__(self, other):
        return (
            self.query_track == other.query_track
            and self.winner_track == other.winner_track
            and abs(self.weight - other.weight) < 1e-6
        )


class Voting:
    def winners(self, distances: Iterable[ObservationMetricOk]):
        raise NotImplementedError


def _grouped_weights(distances, max_distance, min_votes):
    """Group (from,to) votes, compute sum(max_dist - d) weights."""
    records = list(distances)
    max_dist = -1.0
    for r in records:
        if r.feature_distance is not None and r.feature_distance > max_dist:
            max_dist = r.feature_distance
    groups: Dict[tuple, List[float]] = defaultdict(list)
    for r in records:
        if r.feature_distance is not None and r.feature_distance <= max_distance:
            groups[(r.from_id, r.to_id)].append(r.feature_distance)
    out = []
    for (src, dst), dists in groups.items():
        if len(dists) >= min_votes:
            weight = sum(max_dist - d for d in dists)
            out.append(TopNVotingElt(src, dst, weight))
    return out


class TopNVoting(Voting):
    """`voting/topn.rs:16-137`."""

    def __init__(self, topn: int, max_distance: float, min_votes: int):
        self.topn = topn
        self.max_distance = max_distance
        self.min_votes = min_votes

    def winners(self, distances) -> Dict[int, List[TopNVotingElt]]:
        elts = _grouped_weights(distances, self.max_distance, self.min_votes)
        results: Dict[int, List[TopNVotingElt]] = defaultdict(list)
        for e in elts:
            results[e.query_track].append(e)
        for counts in results.values():
            counts.sort(key=lambda e: -e.weight)
            del counts[self.topn :]
        return dict(results)


class SortVoting(Voting):
    """Hungarian voting on the augmented candidate matrix.

    Standalone equivalent of `src/trackers/sort/voting.rs:11-101` (the SORT
    trackers run this fused on device; this class serves the generic engine).
    winners: {candidate_id: [winner_id]}; winner == candidate means new track.
    """

    def __init__(self, threshold: float, candidates_num: int, tracks_num: int):
        self.threshold = threshold
        self.candidates_num = candidates_num
        self.tracks_num = tracks_num

    def winners(self, distances) -> Dict[int, List[int]]:
        import numpy as np
        from scipy.optimize import linear_sum_assignment

        if self.tracks_num == 0:
            return {}
        records = list(distances)
        cand_ids: List[int] = []
        cand_idx: Dict[int, int] = {}
        track_idx: Dict[int, int] = {}
        track_ids: List[int] = []
        for r in records:
            if r.from_id not in cand_idx:
                cand_idx[r.from_id] = len(cand_ids)
                cand_ids.append(r.from_id)
            if r.to_id not in track_idx:
                track_idx[r.to_id] = len(track_ids)
                track_ids.append(r.to_id)
        d = self.candidates_num
        t = len(track_ids)
        W = np.zeros((d, d + t), np.float64)
        for i in range(d):
            W[i, i] = self.threshold
        for r in records:
            W[cand_idx[r.from_id], d + track_idx[r.to_id]] = (
                r.attribute_metric or 0.0
            )
        rows, cols = linear_sum_assignment(W, maximize=True)
        out: Dict[int, List[int]] = {}
        for i, c in zip(rows, cols):
            if i >= len(cand_ids):
                continue
            src = cand_ids[i]
            if c >= d:
                out[src] = [track_ids[c - d]]
            else:
                out[src] = [src]
        return out


class BestFitVoting(Voting):
    """Greedy global claim, `voting/best.rs:18-128`: losers get winner=self."""

    def __init__(self, max_distance: float, min_votes: int):
        self.max_distance = max_distance
        self.min_votes = min_votes

    def winners(self, distances) -> Dict[int, List[TopNVotingElt]]:
        candidates = _grouped_weights(distances, self.max_distance, self.min_votes)
        candidates.sort(key=lambda e: -e.weight)
        claimed = set()
        for c in candidates:
            if c.winner_track in claimed:
                c.winner_track = c.query_track
            else:
                claimed.add(c.winner_track)
        results: Dict[int, List[TopNVotingElt]] = defaultdict(list)
        for c in candidates:
            results[c.query_track].append(c)
        return dict(results)
