"""Generic track store (mirrors `similari_tpu/core/store.py`).

The reference (`track/store.rs`) fans candidates out to thread-per-shard
executors over channels; here the store is a flat dict and
`foreign_track_distances` is one batched sweep.  For metrics that expose
no batch path the sweep calls the Python metric per pair (extensibility
parity); feature-heavy workloads opt in by declaring
`supports_batch_features = "euclidean" | "cosine"` on the metric.

The store's device work is that sweep.  Each feature class has a feature
index: every stored observation's feature stacked into one f32 tensor
[N, F] on the store's device (`device=None` means CUDA and raises without
it; the CPU runs only for `device="cpu"`), built lazily and dropped by the
store's mutators.  A candidate's [L, F] observations go against it in one
`torch.matmul` (f32 with TF32 off, `ops/gallery_dots.py::f32_dots`), with
the JAX package's formulas: the normalised dot for cosine (a similarity),
and sqrt(max(qq - 2 q.g + gg, 0)) for euclidean.  The [L, N] matrix comes
back to the host once per candidate; the per-pair `MetricQuery` loop and
the record API stay Python, as in the JAX package.

The bulk record stream (`ObservationMetric.batch_records`) is left for
the per-pair loop in three cases only, each counted in `bulk_fallbacks`:
a user `compatible()` raises (the per-pair loop records the error), the
metric's `batch_records` raises, or it returns None.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.gallery_dots import f32_dots
from .track import (
    IncompatibleAttributes,
    MetricQuery,
    NoopNotifier,
    Observation,
    ObservationForClassNotFound,
    ObservationMetric,
    ObservationMetricOk,
    Track,
    TrackBuilder,
    TrackStatus,
)


class DuplicateTrackId(Exception):
    pass


class TrackNotFound(Exception):
    pass


class SameTrackCalculation(Exception):
    pass


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _prepare(g: torch.Tensor, kind: str) -> torch.Tensor:
    """The gallery side of `_distances`: unit rows for cosine, squared row
    norms for euclidean."""
    return _unit_rows(g) if kind == "cosine" else (g * g).sum(1)


def _distances(q: torch.Tensor, g: torch.Tensor, g_prep: torch.Tensor,
               kind: str) -> torch.Tensor:
    """q[L, F] x g[N, F] -> [L, N]: cosine similarity, or the euclidean
    distance by the gram expansion; `g_prep` is `_prepare(g, kind)`."""
    if kind == "cosine":
        return f32_dots(_unit_rows(q), g_prep)
    qq = (q * q).sum(1)[:, None]
    return torch.sqrt(torch.clamp(qq - 2.0 * f32_dots(q, g) + g_prep[None, :],
                                  min=0.0))


class _FeatureIndex:
    """Columnar snapshot of one feature class across the whole store.

    rows [N, F] f32 on the store's device: the stacked observation
    features; to_id [N] the owning track id and obs_ix [N] the
    observation's index within its track (numpy int64, on the host).
    Built lazily and invalidated by store-level mutations (`_mutations`
    counter): one product sweeps every stored observation, in place of
    the reference's thread-per-shard distance fan-out.
    """

    __slots__ = ("rows", "to_id", "obs_ix", "prep", "spans", "attrs")

    def __init__(self, rows, to_id, obs_ix, spans, attrs):
        self.rows = rows
        self.to_id = to_id
        self.obs_ix = obs_ix
        self.spans = spans  # {track_id: (start, stop)} contiguous runs
        self.attrs = attrs  # per-row observation attribute (list, may hold None)
        self.prep = None  # lazy `_prepare(rows, kind)` (norms) on the device


class TrackStore:
    def __init__(self, shards: int, default_attributes, metric, notifier=None,
                 device: DeviceLike = None):
        self.num_shards = max(1, shards)
        self.default_attributes = default_attributes
        self.metric = metric
        self.notifier = notifier or NoopNotifier()
        self.device = resolve_device(device)
        self.tracks: Dict[int, Track] = {}
        self.bulk_fallbacks = 0  # times the bulk record stream was left
        self._mutations = 0  # bumped by store-level mutators
        self._findex: Dict[int, Tuple[int, Optional[_FeatureIndex]]] = {}

    def invalidate_index(self):
        """Call after mutating a Track obtained via `get()` directly (the
        store-level mutators invalidate automatically)."""
        self._mutations += 1

    def _feature_index(self, feature_class: int) -> Optional[_FeatureIndex]:
        cached = self._findex.get(feature_class)
        if cached is not None and cached[0] == self._mutations:
            return cached[1]
        rows, to_id, obs_ix, attrs = [], [], [], []
        spans: Dict[int, Tuple[int, int]] = {}
        dim = None
        index: Optional[_FeatureIndex] = None
        ok = True
        for tid, track in self.tracks.items():
            obs = track.observations.get(feature_class)
            if not obs:
                continue
            start = len(rows)
            for j, o in enumerate(obs):
                f = o.feature()
                if f is None or (dim is not None and f.shape[0] != dim):
                    ok = False
                    break
                dim = f.shape[0]
                rows.append(f)
                to_id.append(tid)
                obs_ix.append(j)
                attrs.append(o.attr())
            if not ok:
                break
            spans[tid] = (start, len(rows))
        if ok and rows:
            index = _FeatureIndex(
                torch.from_numpy(np.stack(rows).astype(np.float32, copy=False)
                                 ).to(self.device),
                np.asarray(to_id, np.int64),
                np.asarray(obs_ix, np.int64),
                spans,
                attrs,
            )
        self._findex[feature_class] = (self._mutations, index)
        return index

    # ------------------------------------------------------------- creation
    def new_track(self, track_id: Optional[int] = None) -> TrackBuilder:
        b = TrackBuilder(track_id)
        b.attributes(copy.deepcopy(self.default_attributes))
        b.metric(copy.deepcopy(self.metric))
        b.notifier(self.notifier)
        return b

    def add_track(self, track: Track):
        """`store.rs:510-519`."""
        if track.track_id in self.tracks:
            raise DuplicateTrackId(track.track_id)
        self._mutations += 1
        self.tracks[track.track_id] = track

    def add(
        self,
        track_id: int,
        feature_class: int,
        feature_attribute=None,
        feature=None,
        attributes_update=None,
    ):
        """`store.rs:530-569`: appends to an existing track or creates one
        directly (no optimize on creation)."""
        self._mutations += 1
        track = self.tracks.get(track_id)
        if track is None:
            t = Track(
                attributes=copy.deepcopy(self.default_attributes),
                metric=copy.deepcopy(self.metric),
                notifier=self.notifier,
                track_id=track_id,
            )
            t.observations[feature_class] = [
                Observation(feature_attribute, feature)
            ]
            if attributes_update is not None:
                attributes_update.apply(t.attributes)
            self.tracks[track_id] = t
        else:
            track.add_observation(
                feature_class, feature_attribute, feature, attributes_update
            )

    # ------------------------------------------------------------ distances
    def foreign_track_distances(
        self,
        tracks: Sequence[Track],
        feature_class: int,
        only_baked: bool,
    ) -> Tuple[List[ObservationMetricOk], List[Exception]]:
        """`store.rs:429-460` + the executor branch `store.rs:199-264`.

        IncompatibleAttributes pairs are silently skipped; other metric
        errors are returned in the error list.  `postprocess_distances`
        runs per candidate-vs-track batch like the per-shard batches of the
        reference.
        """
        batch_kind = getattr(self.metric, "supports_batch_features", None)
        distances: List[ObservationMetricOk] = []
        errors: List[Exception] = []
        # bulk record stream: when the metric also implements
        # `batch_records` and keeps the default postprocess, the per-pair
        # loop below collapses into one vectorised record build.  A metric
        # that never overrode batch_records can only return None, so it
        # skips the bulk setup altogether.
        bulk_ok = batch_kind and (
            type(self.metric).postprocess_distances
            is ObservationMetric.postprocess_distances
        ) and (
            type(self.metric).batch_records
            is not ObservationMetric.batch_records
        )
        for cand in tracks:
            # one product against the whole store's feature index, sliced
            # per track below
            pre_all = spans = None
            if batch_kind:
                pre_all, spans = self._sweep_candidate(
                    cand, feature_class, batch_kind)
            if bulk_ok and pre_all is not None:
                recs = self._bulk_records(
                    cand, feature_class, pre_all, only_baked, errors)
                if recs is not None:
                    distances.extend(recs)
                    continue
                self.bulk_fallbacks += 1
            for other_id, other in self.tracks.items():
                if cand.track_id == other_id:
                    continue
                if only_baked:
                    try:
                        status = other.get_attributes().baked(other.observations)
                    except Exception:  # noqa: BLE001 - a failing bake skips
                        continue
                    if status != TrackStatus.Ready:
                        continue
                try:
                    pre = None
                    if pre_all is not None and other_id in spans:
                        s0, s1 = spans[other_id]
                        pre = pre_all[:, s0:s1]
                    if batch_kind:
                        dists = self._distances_batched(
                            cand, other, feature_class, batch_kind, pre=pre
                        )
                    else:
                        dists = cand.distances(other, feature_class)
                    distances.extend(cand.metric.postprocess_distances(dists))
                except IncompatibleAttributes:
                    continue
                except Exception as e:  # noqa: BLE001 - the error stream
                    errors.append(e)
        return distances, errors

    def _bulk_records(self, cand: Track, feature_class: int,
                      pre_all: np.ndarray, only_baked: bool,
                      errors: List[Exception]):
        """One-shot record stream for a candidate.

        Filters store columns by compatibility and bake status per track
        (the same predicate as the per-pair loop), then asks the metric's
        `batch_records` for the whole `ObservationMetricOk` list.  The
        emitted order matches the per-pair loop exactly: track-major (store
        iteration order), then candidate observation, then track
        observation.  Returns None, with `errors` untouched, where the
        per-pair loop must run instead: a user `compatible()` or the
        metric's `batch_records` raised, or `batch_records` returned None.
        """
        index = self._feature_index(feature_class)
        left = cand.observations.get(feature_class)
        keep = np.ones(index.rows.shape[0], bool)
        new_errors: List[Exception] = []
        # the bulk path's only O(tracks) Python loop: bound methods hoisted,
        # slice-stores only on failures
        cid = cand.track_id
        compatible = cand.attributes.compatible
        tracks = self.tracks
        ready = TrackStatus.Ready
        for tid, (s0, s1) in index.spans.items():
            if tid == cid:
                keep[s0:s1] = False
                continue
            other = tracks[tid]
            try:
                ok = compatible(other.attributes)
            except Exception:  # noqa: BLE001 - a user compatible() raised:
                return None  # the per-pair loop records it
            if ok and only_baked:
                try:
                    ok = other.get_attributes().baked(
                        other.observations) is ready
                except Exception:  # noqa: BLE001 - skipped, as the
                    ok = False  # per-pair loop skips it
            if not ok:
                keep[s0:s1] = False
        # error-stream parity: compatible (and baked, when filtering)
        # tracks with NO observations of this class raise
        # ObservationForClassNotFound in the per-pair loop
        if len(index.spans) < len(self.tracks):
            for tid, other in self.tracks.items():
                if tid == cid or tid in index.spans:
                    continue
                if other.observations.get(feature_class) is not None:
                    # class present but EMPTY ([]): the per-pair test
                    # `right is None` does not fire, so it yields no
                    # records and no error
                    continue
                try:
                    ok = compatible(other.attributes)
                except Exception:  # noqa: BLE001 - as above
                    return None
                if ok and only_baked:
                    try:
                        ok = (other.get_attributes()
                              .baked(other.observations) == ready)
                    except Exception:  # noqa: BLE001 - as above
                        ok = False
                if ok:
                    new_errors.append(ObservationForClassNotFound(
                        f"class {feature_class} for {cid}/{tid}"))
        to_ids = index.to_id[keep]
        if len(to_ids) == 0:
            errors.extend(new_errors)
            return []
        right_attrs = (index.attrs if keep.all()
                       else [a for a, k in zip(index.attrs, keep) if k])
        try:
            recs = self.metric.batch_records(
                cid, to_ids, left, right_attrs, pre_all[:, keep])
        except Exception:  # noqa: BLE001 - the metric's own error: the
            return None  # per-pair loop asks `metric()` pair by pair
        if recs is None:
            return None
        n_left = len(left)
        if n_left > 1:
            # batch_records emits candidate-major [L x N]; restore the
            # per-pair loop's track-major order (columns are already
            # track-contiguous, so single-observation candidates need none)
            lengths = np.fromiter((s1 - s0 for s0, s1 in index.spans.values()),
                                  np.int64, len(index.spans))
            trk = np.repeat(np.arange(len(index.spans), dtype=np.int64),
                            lengths)[keep]
            n = len(to_ids)
            i_flat = np.repeat(np.arange(n_left), n)
            j_flat = np.tile(np.arange(n), n_left)
            perm = np.lexsort((j_flat, i_flat, trk[j_flat]))
            recs = [recs[k] for k in perm]
        errors.extend(new_errors)
        return recs

    def _sweep_candidate(self, cand: Track, feature_class: int, kind: str):
        """Candidate observations x the whole store's feature index, on the
        store's device.  Returns (pre [L, N] numpy f32, spans {tid: (start,
        stop)}) or (None, None) when the index or the candidate is
        non-uniform."""
        index = self._feature_index(feature_class)
        if index is None:
            return None, None
        left = cand.observations.get(feature_class)
        if not left:
            return None, None
        lf = [o.feature() for o in left]
        if any(f is None or f.shape[0] != index.rows.shape[1] for f in lf):
            return None, None
        q = torch.from_numpy(np.stack(lf).astype(np.float32, copy=False)
                             ).to(self.device)
        if index.prep is None:
            index.prep = _prepare(index.rows, kind)
        pre = _distances(q, index.rows, index.prep, kind)
        return pre.cpu().numpy(), index.spans

    def foreign_track_distances_arrays(
        self, cand: Track, feature_class: int, only_baked: bool = False
    ):
        """Array-native store query (the production search path).

        The reference's `foreign_track_distances` streams one record per
        observation pair through channels (`store.rs:429-460`); this is
        the same query as ONE matrix: returns (to_id [N] int64, obs_ix [N]
        int64, dist [L, N] f32) numpy arrays over every live observation of
        `feature_class`, where L = candidate observations.  Cosine metrics
        report similarity (the `_distances_batched` convention).  Requires
        a metric with `supports_batch_features` and uniform feature dims
        across the store (raises ValueError otherwise: use the record API
        for mixed stores).
        """
        kind = getattr(self.metric, "supports_batch_features", None)
        if kind not in ("euclidean", "cosine"):
            raise ValueError(
                "metric does not declare supports_batch_features")
        pre, spans = self._sweep_candidate(cand, feature_class, kind)
        if pre is None:
            raise ValueError(
                "store/candidate features are missing or non-uniform; "
                "use foreign_track_distances instead")
        index = self._feature_index(feature_class)
        keep = index.to_id != cand.track_id
        for tid, (s0, s1) in spans.items():
            if tid == cand.track_id:
                continue
            other = self.tracks[tid]
            ok = cand.attributes.compatible(other.attributes)
            if ok and only_baked:
                try:
                    ok = (other.get_attributes().baked(other.observations)
                          == TrackStatus.Ready)
                except Exception:  # noqa: BLE001 - parity with record API
                    ok = False
            if not ok:
                keep[s0:s1] = False
        return index.to_id[keep], index.obs_ix[keep], pre[:, keep]

    def _distances_batched(
        self, cand: Track, other: Track, feature_class: int, kind: str,
        pre: Optional[np.ndarray] = None,
    ) -> List[ObservationMetricOk]:
        """`Track.distances` with the feature part precomputed as one matrix.

        The reference's per-pair loops (`src/distance.rs:9-47`) become one
        product over all left x right observations; each `MetricQuery`
        carries its pair's value in `precomputed_distance`, so the metric
        only evaluates the attribute part.  `pre` (from the store-wide
        `_sweep_candidate`) skips the product; without it the block is
        computed on the store's device, and when an observation lacks a
        feature or the dims differ the queries go without a value.
        """
        if not cand.attributes.compatible(other.attributes):
            raise IncompatibleAttributes(
                f"{cand.track_id} incompatible with {other.track_id}"
            )
        left = cand.observations.get(feature_class)
        right = other.observations.get(feature_class)
        if left is None or right is None:
            raise ObservationForClassNotFound(
                f"class {feature_class} for {cand.track_id}/{other.track_id}"
            )
        if pre is not None and pre.shape != (len(left), len(right)):
            pre = None  # shape drifted (direct Track mutation): recompute
        feats = [o.feature() for o in left + right]
        if (pre is None and all(f is not None for f in feats)
                and len({f.shape[0] for f in feats}) == 1):
            x = torch.from_numpy(np.stack(feats).astype(np.float32)
                                 ).to(self.device)
            q, g = x[:len(left)], x[len(left):]
            pre = _distances(q, g, _prepare(g, kind), kind).cpu().numpy()
        out = []
        for i, l in enumerate(left):
            for j, r in enumerate(right):
                mq = MetricQuery(
                    feature_class=feature_class,
                    candidate_attrs=cand.attributes,
                    candidate_observation=l,
                    track_attrs=other.attributes,
                    track_observation=r,
                    precomputed_distance=(
                        float(pre[i, j]) if pre is not None else None
                    ),
                )
                res = cand.metric.metric(mq)
                if res is None:
                    continue
                attribute_metric, feature_distance = res
                out.append(
                    ObservationMetricOk(
                        from_id=cand.track_id,
                        to_id=other.track_id,
                        attribute_metric=attribute_metric,
                        feature_distance=feature_distance,
                    )
                )
        return out

    def owned_track_distances(
        self, track_ids: Sequence[int], feature_class: int, only_baked: bool
    ) -> Tuple[List[ObservationMetricOk], List[Exception]]:
        """`store.rs:471-486`: pull tracks out, compare, re-insert."""
        pulled = self.fetch_tracks(track_ids)
        try:
            return self.foreign_track_distances(pulled, feature_class, only_baked)
        finally:
            for t in pulled:
                self.tracks[t.track_id] = t
            if pulled:
                self._mutations += 1

    # ------------------------------------------------------------- lifecycle
    def find_usable(self) -> List[Tuple[int, object]]:
        """(track_id, TrackStatus | Exception) for non-Pending tracks,
        `store.rs:179-198,355-374`."""
        out = []
        for track_id, track in self.tracks.items():
            try:
                status = track.get_attributes().baked(track.observations)
            except Exception as e:  # noqa: BLE001 - reported, as the reference
                out.append((track_id, e))
                continue
            if status != TrackStatus.Pending:
                out.append((track_id, status))
        return out

    def fetch_tracks(self, track_ids: Sequence[int]) -> List[Track]:
        res = []
        for tid in track_ids:
            t = self.tracks.pop(tid, None)
            if t is not None:
                res.append(t)
        if res:
            self._mutations += 1
        return res

    def get(self, track_id: int) -> Optional[Track]:
        # hands out a MUTABLE Track handle: invalidate the feature index so
        # in-place observation edits through the handle cannot serve stale
        # distances (the rebuild is lazy, so a read-only get costs a counter)
        self._mutations += 1
        return self.tracks.get(track_id)

    def merge_external(
        self,
        dest_id: int,
        src: Track,
        classes: Optional[Sequence[int]] = None,
        merge_history: bool = False,
    ):
        """`store.rs:265-288,677-691`."""
        dest = self.tracks.get(dest_id)
        if dest is None:
            raise TrackNotFound(dest_id)
        if dest_id == src.track_id:
            raise SameTrackCalculation(dest_id)
        use_classes = classes if classes else src.get_feature_classes()
        self._mutations += 1
        dest.merge(src, use_classes, merge_history)

    def merge_owned(
        self,
        dest_id: int,
        src_id: int,
        classes: Optional[Sequence[int]] = None,
        merge_history: bool = False,
    ):
        """`store.rs:584-611`: merge a stored track into another stored one;
        the source is removed on success."""
        src_list = self.fetch_tracks([src_id])
        if not src_list:
            raise TrackNotFound(src_id)
        src = src_list[0]
        try:
            self.merge_external(dest_id, src, classes, merge_history)
        except Exception:
            self.tracks[src_id] = src
            raise

    def lookup(self, query) -> List[Tuple[int, object]]:
        """`store.rs:697-716`."""
        out = []
        for track_id, track in self.tracks.items():
            if track.lookup(query):
                try:
                    status = track.get_attributes().baked(track.observations)
                except Exception as e:  # noqa: BLE001 - reported
                    status = e
                out.append((track_id, status))
        return out

    def shard_stats(self) -> List[int]:
        """Track counts per logical shard (id % num_shards), `store.rs:378-384`."""
        stats = [0] * self.num_shards
        for tid in self.tracks:
            stats[tid % self.num_shards] += 1
        return stats

    def clear(self):
        self._mutations += 1
        self.tracks.clear()

    def __len__(self):
        return len(self.tracks)


class TrackStoreBuilder:
    """`store/builder.rs:10-102`; `device` is the feature index's device
    (None = CUDA)."""

    def __init__(self, shards: int = 0, device: DeviceLike = None):
        self._shards = shards if shards > 0 else (os.cpu_count() or 1)
        self._device = device
        self._default_attributes = None
        self._metric = None
        self._notifier = NoopNotifier()

    def default_attributes(self, attrs):
        self._default_attributes = attrs
        return self

    def metric(self, metric):
        self._metric = metric
        return self

    def notifier(self, notifier):
        self._notifier = notifier
        return self

    def build(self) -> TrackStore:
        return TrackStore(
            self._shards, self._default_attributes, self._metric,
            self._notifier, device=self._device
        )
