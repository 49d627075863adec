"""FeatureTracker: the reference's generic similarity engine over raw
feature vectors, vectorized (mirrors `similari_tpu/trackers/feature.py`).

The reference's "feature tracker" is its generic `Track`/`TrackStore`
engine driven directly: per epoch one fresh candidate track per object
carrying a feature vector, euclidean distances against every stored
track's gallery (kept at the newest 3 observations by `optimize`),
`TopNVoting(1, 100, 1)` winners, merge-or-add
(`benches/feature_tracker.rs:95-170`; `track.rs:604-652`,
`track/voting/topn.rs:16-136`).  This is the throughput form of the same
semantics:

* the track store is a flat ``[T, G, F]`` gallery ring plus counters;
* candidate x gallery-lane scoring is norm-windowed: only lanes with
  ``| |q| - |g| | <= max_distance`` can score, so clustered workloads
  evaluate a few exact pairwise-difference distances per candidate;
  overlapping norms and small frames take ONE sgemm
  (``d^2 = |x|^2 + |y|^2 - 2 x.y``, centred when the norms are large
  enough for the expansion's f32 cancellation to approach the gate);
* TopN voting: votes = count of in-threshold gallery lanes, weight =
  sum(max_distance - d) over them (`topn.rs:92-109`), winner = arg-max
  weight among tracks with >= min_votes;
* merges append into the gallery ring, losers become new tracks; several
  candidates may win the same track in one epoch, in submission order, as
  in the reference's sequential merge loop.

It runs on the host (NumPy/BLAS) by design, as in the JAX package: the
product metric is per-epoch latency at tens to hundreds of objects, where
one sgemm of [D, F] x [F, T*G] on the host beats a device round trip.
The code is the JAX module's, op for op, so the two give the same ids and
galleries.
"""

from __future__ import annotations

import numpy as np

DEFAULT_MAX_DISTANCE = 100.0  # feature_tracker.rs:106 (TopNVoting max dist)


class FeatureTracker:
    """Similarity tracker over raw feature vectors (no boxes, no Kalman).

    Parameters mirror the reference bench's engine configuration:
    gallery = max observations kept per track (3), max_distance = both the
    metric's postprocess threshold and the voting max distance (100),
    min_votes = TopN min_votes (1).  metric: "euclidean" | "cosine".
    """

    def __init__(self, feature_dim: int, gallery: int = 3,
                 max_distance: float = DEFAULT_MAX_DISTANCE,
                 min_votes: int = 1, metric: str = "euclidean",
                 initial_capacity: int = 128):
        assert metric in ("euclidean", "cosine")
        self.dim = feature_dim
        self.gallery = gallery
        self.max_distance = np.float32(max_distance)
        self.min_votes = min_votes
        self.metric = metric
        t = initial_capacity
        # gallery ring stored flat [T*G, F] so the distance sgemm needs no
        # reshape/copy; lane j of track i lives at row i*G + j
        self._feats = np.zeros((t * gallery, feature_dim), np.float32)
        # |y|^2 per lane.  Euclidean stores +inf on DEAD lanes: the distance
        # comes out +inf, so dead lanes drop out of votes and weights with
        # no [D, lanes] mask pass at all.  Cosine keeps 0 (inf would corrupt
        # the denom) and masks explicitly.
        self._dead_norm = np.float32(np.inf if metric == "euclidean" else 0.0)
        self._norms = np.full((t * gallery,), self._dead_norm, np.float32)
        self._live = np.zeros((t * gallery,), bool)
        self._count = np.zeros((t,), np.int64)  # total observations ever
        self._ids = np.zeros((t,), np.int64)
        self._active = np.zeros((t,), bool)
        self._next_id = 0
        # slots are allocated sequentially and never freed (the generic
        # engine has no lifecycle: NoopAttributes.baked is always Ready), so
        # `_used` is a watermark and every matrix op slices to live rows
        self._used = 0
        # largest |feature|^2 ever stored: decides whether the dense gram
        # expansion needs centering (cancellation ~ulps of this)
        self._max_norm = 0.0

    # ------------------------------------------------------------------ api
    @property
    def capacity(self) -> int:
        return len(self._count)

    def __len__(self) -> int:
        return int(self._active.sum())

    def track_ids(self) -> np.ndarray:
        return self._ids[self._active].copy()

    def gallery_of(self, track_id: int) -> np.ndarray:
        """Live gallery rows of a track (newest-last ring order unwound)."""
        (slots,) = np.nonzero(self._active & (self._ids == track_id))
        if not len(slots):
            raise KeyError(track_id)
        s = int(slots[0])
        g = self.gallery
        n = int(min(self._count[s], g))
        order = [(self._count[s] - n + j) % g for j in range(n)]
        return self._feats[[s * g + o for o in order]].copy()

    def _grow(self, need: int):
        t = self.capacity
        new_t = t
        while new_t < need:
            new_t *= 2
        if new_t == t:
            return
        g = self.gallery
        pad = new_t - t

        def padded(a, rows, fill=0):
            ext = np.full((rows,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, ext])

        self._feats = padded(self._feats, pad * g)
        self._norms = padded(self._norms, pad * g, fill=self._dead_norm)
        self._live = padded(self._live, pad * g)
        self._count = padded(self._count, pad)
        self._ids = padded(self._ids, pad)
        self._active = padded(self._active, pad)

    def predict(self, features: np.ndarray) -> np.ndarray:
        """One epoch: features[D, F] -> winner track id per candidate [D].

        Semantics of the reference loop (`feature_tracker.rs:119-170`):
        distances -> TopN winners -> merge into winner or become new track.
        """
        feats = np.ascontiguousarray(features, np.float32)
        d = feats.shape[0]
        if d == 0:
            return np.zeros((0,), np.int64)
        self._grow(self._used + d)
        g = self.gallery
        u = self._used
        qn = np.einsum("df,df->d", feats, feats)
        self._max_norm = max(self._max_norm, float(qn.max()))

        if u == 0:
            matched = np.zeros((d,), bool)
            tgt = np.zeros((d,), np.int64)
        elif self.metric == "euclidean" and self.min_votes <= 1:
            # --- norm-windowed exact pair path (the bench configuration) --
            # dist >= | |q| - |g| |, so only gallery lanes whose norm falls
            # inside [|q| - maxd, |q| + maxd] can score a nonzero clamped
            # weight (the spatial-hash idea, in norm space).  On clustered
            # workloads (the reference bench: tracks ~1000 units apart at
            # maxd 100) that is a few lanes per candidate, and the
            # surviving pairs run the reference's own pairwise-difference
            # distance.  That also avoids the all-lanes gram expansion
            # (qn + |g|^2 - 2 q.g), which cancels in f32 at large feature
            # norms (error floor ~ sqrt(eps)*|q|: 100+ units at |q| ~ 4e5,
            # so one static object would split into several tracks).
            # Dead lanes carry +inf norms
            # -> sorted last, never inside a window.  Boundary caveat: the
            # window bounds use the stored f32 norms, so a pair sitting
            # within ~|q|*1e-7 of EXACTLY max_distance may land on the
            # other side of the gate vs the dense path — same measure-zero
            # class as the dense path's own dead-lane note.
            lanes = u * g
            maxd = self.max_distance

            def dense_centered():
                # one sgemm + in-place passes.  The gram
                # expansion's cancellation error is ~ulps of the largest
                # norm, so when every norm is small relative to the gate it
                # runs as-is on the stored norms (dead lanes +inf already);
                # otherwise the data is CENTERED on the candidate mean so
                # the cancellation scales with the spread, not the absolute
                # norm (dead lanes re-masked: their stored rows are stale,
                # so the recomputed centered norm would be finite).
                big = max(float(qn.max()), self._max_norm)
                if big * 1e-6 < (0.1 * float(maxd)) ** 2:
                    fc, galc = feats, self._feats[:lanes]
                    qnc, nc = qn, self._norms[:lanes]
                else:
                    c = feats.mean(axis=0)
                    fc = feats - c
                    galc = self._feats[:lanes] - c
                    qnc = np.einsum("df,df->d", fc, fc)
                    nc = np.einsum("lf,lf->l", galc, galc)
                    nc[~self._live[:lanes]] = np.float32(np.inf)
                buf = fc @ galc.T  # [D, used*G] BLAS
                np.multiply(buf, np.float32(-2.0), out=buf)
                buf += qnc[:, None]
                buf += nc[None, :]
                np.maximum(buf, np.float32(0.0), out=buf)
                np.sqrt(buf, out=buf)
                np.minimum(buf, maxd, out=buf)
                np.subtract(maxd, buf, out=buf)
                w3 = buf.reshape(d, u, g)
                weight = w3[:, :, 0].copy()
                for j in range(1, g):
                    weight += w3[:, :, j]
                return weight

            weight = None
            if d * lanes > 4096:  # window machinery beats the sgemm only
                # once the dense matrix is real work
                sq = np.sqrt(qn)
                sn = np.sqrt(self._norms[:lanes])
                order = np.argsort(sn, kind="stable")
                sns = sn[order]
                lo = np.searchsorted(sns, sq - maxd, "left")
                hi = np.searchsorted(sns, sq + maxd, "right")
                cnt = hi - lo
                p_total = int(cnt.sum())
                if p_total <= max(4096, (d * lanes) // 8):
                    weight = np.zeros((d, u), np.float32)
                    if p_total:
                        rows = np.repeat(np.arange(d), cnt)
                        stops = np.cumsum(cnt)
                        pos = (np.arange(p_total) - np.repeat(
                            stops - cnt, cnt) + np.repeat(lo, cnt))
                        lane = order[pos]
                        diff = feats[rows] - self._feats[lane]
                        w = np.einsum("pf,pf->p", diff, diff)
                        np.sqrt(w, out=w)
                        np.minimum(w, maxd, out=w)
                        np.subtract(maxd, w, out=w)
                        np.add.at(weight, (rows, lane // g), w)
            if weight is None:  # small frame or overlapping norms
                weight = dense_centered()
            tgt = np.argmax(weight, axis=1)
            matched = weight[np.arange(d), tgt] > 0.0
        else:
            # --- distance matrix: one sgemm over live gallery lanes ------
            # (`track.rs:616-643` cartesian loop -> [D, used*G] batch)
            lanes = u * g
            gal = self._feats[:lanes]
            if self.metric == "euclidean":
                # same norm-gated centering as the fast path's dense route
                # (the uncentered gram cancels at large norms)
                if (max(float(qn.max()), self._max_norm) * 1e-6
                        < (0.1 * float(self.max_distance)) ** 2):
                    fc, galc = feats, gal
                    qnc, nc = qn, self._norms[:lanes]
                else:
                    c = feats.mean(axis=0)
                    fc = feats - c
                    galc = gal - c
                    qnc = np.einsum("df,df->d", fc, fc)
                    nc = np.einsum("lf,lf->l", galc, galc)
                dot = fc @ galc.T  # [D, used*G] BLAS
                d2 = np.maximum(qnc[:, None] + nc[None, :] - 2.0 * dot, 0.0)
                dist = np.sqrt(d2, dtype=np.float32)
            else:
                dot = feats @ gal.T  # [D, used*G] BLAS
                denom = np.sqrt(qn[:, None] * self._norms[None, :lanes])
                dist = np.float32(1.0) - dot / np.where(denom > 0, denom, 1.0)
            ok = self._live[None, :lanes] & (dist <= self.max_distance)

            # --- TopN voting (n=1): votes + weights per track ------------
            okw = np.where(ok, self.max_distance - dist, 0.0)
            votes = ok.reshape(d, u, g).sum(axis=2)
            weight = okw.reshape(d, u, g).sum(axis=2)
            weight = np.where(votes >= self.min_votes, weight, -1.0)
            tgt = np.argmax(weight, axis=1)
            matched = weight[np.arange(d), tgt] >= 0.0

        # --- merge / add --------------------------------------------------
        # vectorized fast path when no two candidates hit the same track
        # (the overwhelmingly common case); sequential-append fallback keeps
        # exact parity with the reference's merge loop otherwise
        is_new = ~matched
        n_new = int(is_new.sum())
        slot = np.where(matched, tgt, 0)
        if n_new:
            slot[is_new] = self._used + np.arange(n_new)
        mt = slot[matched]
        # duplicate-winner check: a Python set beats np.unique on few
        # entries
        distinct = (len(set(mt.tolist())) if mt.size <= 64
                    else np.unique(mt).size)
        if mt.size == distinct:
            if n_new:
                ns = slot[is_new]
                self._ids[ns] = self._next_id + 1 + np.arange(n_new)
                self._active[ns] = True
                self._count[ns] = 0
                self._next_id += n_new
                self._used += n_new
            lane = slot * g + (self._count[slot] % g)
            self._feats[lane] = feats
            self._norms[lane] = qn
            self._live[lane] = True
            self._count[slot] += 1
            return self._ids[slot].copy()

        out = np.empty((d,), np.int64)
        for i in range(d):
            s = int(slot[i])
            if is_new[i]:
                self._next_id += 1
                self._ids[s] = self._next_id
                self._active[s] = True
                self._count[s] = 0
                self._used = max(self._used, s + 1)
            lane = s * g + int(self._count[s] % g)
            self._feats[lane] = feats[i]
            self._norms[lane] = qn[i]
            self._live[lane] = True
            self._count[s] += 1
            out[i] = self._ids[s]
        return out

    def wasted(self) -> np.ndarray:
        """No lifecycle in the generic engine (`NoopAttributes.baked` is
        always Ready); exposed for API symmetry."""
        return np.zeros((0,), np.int64)
