"""Plain NumPy SORT and VisualSORT, one scene at a time, in float64.

A frozen copy of the semantics of the repository's test oracles
(`tests/reference_sort.py`, `tests/reference_visual.py`: the reference
project's per-track Kalman filter, per-pair metrics, BestFit claim on
feature votes, an exact assignment on the positional remainder), written
over slot arrays so that a check of hundreds of frames fits after a run.
Slots are kept as the tracker keeps them: a new track takes the lowest free
slot, tracks idle past `max_idle_epochs` are retired at the top of a frame
(`recycle_idle`), and a frame whose new tracks do not fit writes nothing.

It imports nothing of the program.  The assignment is exact (scipy's
Hungarian); where the program's assignment differs from it, `Tracker.step`
takes the program's only when that is as good as the optimum up to the
auction's own guarantee (`AUCTION_SLACK`), and says so.

`bf16=True` keeps the state in bfloat16 (every float of the Kalman state
and the gallery rounded after each frame): the lower-precision control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

NEG = -1e30
VT_VISUAL, VT_POSITIONAL = 0, 1
# a positional pair whose weight the program computed in float32 may sit
# this far on the other side of the threshold (boxes of ~1000 px carry
# ~1e-4 px of rounding; IoU moves ~3e-6 for it)
PAIR_SLACK = 1e-4
# the program's BestFit weights come from float32 gram-form distances;
# two weights are a tie where they lie within this many times the move
# float32 gram-form arithmetic makes in them (measured on the same pairs)
VOTE_SLACK = 4.0
# the forward auction ends eps-optimal: its total lies within
# (rows bidding) x eps of the optimum, eps = span / max(4096, 64 D)
AUCTION_SLACK = 1.0


def round_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    a = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    a = (a + np.uint32(0x7FFF) + ((a >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return a.view(np.float32).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The tracker settings a configuration file states."""

    tracker: str  # "sort" | "visualsort"
    iou_threshold: float
    min_confidence: float
    max_idle_epochs: int
    recycle_idle: bool
    position_weight: float = 1.0 / 20.0
    velocity_weight: float = 1.0 / 160.0
    visual_threshold: float = 3.4e38
    visual_minimal_track_length: int = 1
    visual_min_votes: int = 1
    visual_minimal_area: float = 0.0
    visual_minimal_quality_use: float = 0.0
    visual_minimal_quality_collect: float = 0.0

    @classmethod
    def from_config(cls, config: Dict) -> "Settings":
        s = config["settings"]
        visual = config["tracker"] == "visualsort"
        if s.get("oriented", False) or (
                visual and (s.get("positional_kind") != "iou"
                            or s.get("visual_kind") != "euclidean")):
            raise ValueError("the reference covers aligned IoU positional "
                             "matching and euclidean feature distances")
        if s.get("own_area_use", 0.0) or s.get("own_area_collect", 0.0):
            raise ValueError("the reference takes no own-area gates")
        keep = {f.name for f in dataclasses.fields(cls)} - {
            "tracker", "min_confidence"}
        conf = (s["positional_min_confidence"] if visual
                else s["min_confidence"])
        return cls(tracker=config["tracker"], min_confidence=conf,
                   **{k: v for k, v in s.items() if k in keep})


def _box_var(k, cnst, h, weight):
    s = (k * weight) * h
    out = np.stack([s, s, s, np.full_like(s, cnst), s], -1)
    return out * out


def kf_initiate(z, pw, vw):
    zero = np.zeros_like(z)
    return [z.copy(), zero, _box_var(2.0, 1e-2, z[:, 4], pw), zero.copy(),
            _box_var(10.0, 1e-5, z[:, 4], vw)]


def kf_predict(kf, pw, vw):
    mp, mv, cpp, cpv, cvv = kf
    qp = _box_var(1.0, 1e-2, mp[:, 4], pw)
    qv = _box_var(1.0, 1e-5, mp[:, 4], vw)
    return [mp + mv, mv, cpp + 2.0 * cpv + cvv + qp, cpv + cvv, cvv + qv]


def kf_update(kf, z, pw):
    mp, mv, cpp, cpv, cvv = kf
    S = cpp + _box_var(1.0, 1e-1, mp[:, 4], pw)
    nu = z - mp
    gp, gv = cpp / S, cpv / S
    return [mp + nu * gp, mv + nu * gv, cpp - cpp * gp, cpv - cpp * gv,
            cvv - cpv * gv]


def aligned_iou(a, b):
    """(iou, valid) [D, T] of boxes a [D, 5] and b [T, 5]."""
    aw, bw = a[:, 3] * a[:, 4], b[:, 3] * b[:, 4]
    iw = (np.minimum(a[:, None, 0] + aw[:, None] * 0.5,
                     b[None, :, 0] + bw[None] * 0.5)
          - np.maximum(a[:, None, 0] - aw[:, None] * 0.5,
                       b[None, :, 0] - bw[None] * 0.5))
    ih = (np.minimum(a[:, None, 1] + a[:, None, 4] * 0.5,
                     b[None, :, 1] + b[None, :, 4] * 0.5)
          - np.maximum(a[:, None, 1] - a[:, None, 4] * 0.5,
                       b[None, :, 1] - b[None, :, 4] * 0.5))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = (aw * a[:, 4])[:, None] + (bw * b[:, 4])[None] - inter
    valid = (inter > 0) & (union > 0)
    return np.where(valid, inter / np.where(valid, union, 1.0), 0.0), valid


def first_argmax(v, axis):
    """Lowest index of the maximum along `axis`."""
    return np.argmax(v, axis=axis)  # numpy takes the first maximum


def optimal_matches(W, thr):
    """The exact voting LP: each row takes a column with weight W >= thr
    or its own new-track column worth thr.  Returns {row: column}."""
    rows = np.flatnonzero((W >= thr).any(1))
    cols = np.flatnonzero((W >= thr).any(0))
    if not len(rows):
        return {}
    sub = W[np.ix_(rows, cols)]
    gain = np.where(sub >= thr, sub - thr, 0.0)
    r, c = linear_sum_assignment(gain, maximize=True)
    return {int(rows[i]): int(cols[j]) for i, j in zip(r, c)
            if sub[i, j] >= thr}


def lp_total(W, thr, open_rows, matches):
    return (sum(W[r, c] for r, c in matches.items())
            + thr * (len(open_rows) - len(matches)))


def _bestfit_tie(w, slack, eligible, ref, prog) -> bool:
    """Whether the program's BestFit claims `prog` ({row: track}) differ
    from the reference's `ref` only where weights tie within `slack`: each
    of its claims is, within the slack, its row's heaviest track and its
    track's heaviest row, and each claim of the reference that wins by
    more than the slack on both sides is among the program's."""
    if len(set(prog.values())) != len(prog):
        return False
    for r, t in prog.items():
        if not eligible[r, t]:
            return False
        near = w[r, t] + slack[r, t]
        if (w[r] - slack[r] > near).any() or (w[:, t] - slack[:, t] > near).any():
            return False
    for r, t in ref.items():
        if prog.get(r) == t:
            continue
        far = w[r, t] - slack[r, t]
        rivals = np.r_[np.delete(w[r] + slack[r], t),
                       np.delete(w[:, t] + slack[:, t], r)]
        if (rivals < far).all():
            return False
    return True


@dataclasses.dataclass
class StepResult:
    ids: np.ndarray  # [D] int64 (valid rows)
    slots: np.ndarray
    vt: np.ndarray
    is_new: np.ndarray
    pred: np.ndarray  # [D, 5]
    tie: bool  # took the program's assignment, an equal optimum
    refused: int  # program rows whose assignment the reference refuses


class Tracker:
    """One scene: capacity T, gallery K, features F (0 for SORT), rows
    padded to `dpad` (the auction's eps depends on it)."""

    def __init__(self, settings: Settings, capacity: int, dpad: int,
                 gallery: int = 0, feature_dim: int = 0, bf16: bool = False):
        t, k, f = capacity, gallery, feature_dim
        self.s, self.t, self.k, self.f, self.dpad = settings, t, k, f, dpad
        self.visual = settings.tracker == "visualsort"
        self.bf16 = bf16
        self.active = np.zeros(t, bool)
        self.last_epoch = np.zeros(t, np.int64)
        self.length = np.zeros(t, np.int64)
        self.track_id = np.zeros(t, np.int64)
        self.kf = [np.zeros((t, 5)) for _ in range(5)]
        self.obs = np.zeros((t, 5))
        self.conf = np.zeros(t)
        self.next_id = 0
        if self.visual:
            self.feats = np.zeros((t, k, f))
            self.fq = np.zeros((t, k))
            self.fv = np.zeros((t, k), bool)
            self.collected = np.zeros(t, np.int64)
            self.vtype = np.zeros(t, np.int64)
            self.hist_feat = np.zeros((t, f))
            self.hist_fv = np.zeros(t, bool)

    # -- matching ---------------------------------------------------------

    def _positional(self, box, conf, valid, compat):
        """(m, ok) [D, T]: IoU x clamped confidence, and where the boxes
        overlap, over valid rows and compatible tracks (0 elsewhere)."""
        d, t = box.shape[0], self.t
        m, ok = np.zeros((d, t)), np.zeros((d, t), bool)
        rows, cols = np.flatnonzero(valid), np.flatnonzero(compat)
        if len(rows) and len(cols):
            iou, v = aligned_iou(box[rows], self.kf[0][cols])
            conf = np.maximum(conf[rows], self.s.min_confidence)
            m[np.ix_(rows, cols)] = iou * conf[:, None]
            ok[np.ix_(rows, cols)] = v
        return m, ok

    def _visual(self, feat, use_gate, compat):
        """(votes, weight, slack) [D, T]: the passing gallery lanes of each
        (candidate, track), the BestFit weight sum(max_dist - dist) over
        them (max_dist the largest passing distance of the frame), and how
        far float32 gram-form arithmetic moves that weight (VOTE_SLACK
        times its move here)."""
        s = self.s
        d, t = feat.shape[0], self.t
        votes, weight = np.zeros((d, t), np.int64), np.zeros((d, t))
        slack = np.zeros((d, t))
        tracks = np.flatnonzero(
            compat & (self.collected >= s.visual_minimal_track_length))
        rows = np.flatnonzero(use_gate)
        if not len(rows) or not len(tracks):
            return votes, weight, slack
        k = self.k
        g = self.feats[tracks].reshape(len(tracks) * k, -1)
        q = feat[rows]
        # screen every pair in float32 (its gram-form error stays under
        # 1e-3 of |a|^2 + |b|^2), then take each pair that may pass in
        # float64 from its difference
        q32, g32 = q.astype(np.float32), g.astype(np.float32)
        n = (q32 * q32).sum(1)[:, None] + (g32 * g32).sum(1)[None]
        d2 = n - 2.0 * (q32 @ g32.T)
        thr = np.float64(s.visual_threshold)
        with np.errstate(over="ignore"):
            cand = d2 <= thr * thr + 1e-3 * n + 1.0
        cand &= self.fv[tracks].reshape(-1)[None]
        ri, li = np.nonzero(cand)
        diff = q[ri] - g[li]
        dist = np.sqrt(np.einsum("cf,cf->c", diff, diff))
        ok = dist <= thr
        if ok.any():
            d32 = np.sqrt(np.maximum(d2[ri[ok], li[ok]], 0.0)).astype(
                np.float64)
            ri, li, dist = ri[ok], li[ok], dist[ok]
            max_dist = dist.max()
            rr, tt = rows[ri], tracks[li // k]
            np.add.at(votes, (rr, tt), 1)
            np.add.at(weight, (rr, tt), max_dist - dist)
            w32 = np.zeros((d, t))
            np.add.at(w32, (rr, tt), d32.max() - d32)
            slack = VOTE_SLACK * np.abs(w32 - weight) + 1e-9
        return votes, weight, slack

    def _check_program(self, P, pvalid, thr, open_rows, open_cols, ref,
                       prog):
        """(matches to use, tie, refused rows) when the program's positional
        matches `prog` differ from the optimum `ref`."""
        if prog == ref:
            return ref, False, 0
        ok = len(set(prog.values())) == len(prog)
        for r, c in prog.items():
            ok &= (r in open_rows and c in open_cols and pvalid[r, c]
                   and P[r, c] >= thr - PAIR_SLACK)
        if ok:
            W = np.where(pvalid, P, 0.0)
            span = max(W.max(initial=0.0), thr)
            eps = span / max(4096.0, 64.0 * self.dpad)
            slack = len(open_rows) * (AUCTION_SLACK * eps + PAIR_SLACK)
            Wp = np.where(pvalid, P, 0.0)
            if (lp_total(Wp, thr, open_rows, prog)
                    >= lp_total(Wp, thr, open_rows, ref) - slack):
                return prog, True, 0
        differ = {r for r in set(ref) | set(prog) if ref.get(r) != prog.get(r)}
        return ref, False, len(differ)

    # -- one frame --------------------------------------------------------

    def step(self, inp: Dict[str, np.ndarray], epoch: int,
             prog: Optional[Dict[str, np.ndarray]] = None) -> StepResult:
        # padded rows (all zero) divide zero by zero in the Kalman
        # update; their values are never written or compared
        with np.errstate(invalid="ignore", divide="ignore"):
            return self._step(inp, epoch, prog)

    def _step(self, inp, epoch, prog) -> StepResult:
        """One frame: `inp` holds box [D, 5], conf, valid, qual and, for
        VisualSORT, feat [D, F] and fvalid.  `prog`, the program's outputs
        of this frame (slots, vt, is_new over the rows), lets the step take
        the program's assignment where it is an equal optimum."""
        s = self.s
        box = inp["box"].astype(np.float64)
        conf = inp["conf"].astype(np.float64)
        valid = inp["valid"].astype(bool)
        d, t = box.shape[0], self.t
        if s.recycle_idle:
            self.active &= epoch - self.last_epoch <= s.max_idle_epochs
        compat = self.active & (epoch - self.last_epoch <= s.max_idle_epochs)
        thr = s.iou_threshold
        P, raw_ok = self._positional(box, conf, valid, compat)
        pvalid = raw_ok & (P >= thr)

        wins = {}
        has_any = np.zeros(d, bool)
        refused = 0
        weight = None
        tie_visual = False
        if self.visual:
            feat = inp["feat"].astype(np.float64)
            fvalid = inp["fvalid"].astype(bool)
            qual = inp["qual"].astype(np.float64)
            area_ok = box[:, 3] * box[:, 4] * box[:, 4] >= \
                s.visual_minimal_area
            use_gate = (fvalid & valid
                        & (qual >= s.visual_minimal_quality_use) & area_ok)
            collect_gate = (fvalid
                            & (qual >= s.visual_minimal_quality_collect)
                            & area_ok)
            votes, weight, vslack = self._visual(feat, use_gate, compat)
            eligible = (votes >= s.visual_min_votes) & valid[:, None]
            w = np.where(eligible, weight, NEG)
            t1 = first_argmax(w, 1)
            has_any = eligible.any(1)
            best_query = first_argmax(w, 0)
            for r in np.flatnonzero(has_any):
                if best_query[t1[r]] == r:
                    wins[int(r)] = int(t1[r])
            pwins = {}
            if prog is not None:
                pwins = {int(r): int(prog["slots"][r]) for r in np.flatnonzero(
                    valid & (prog["vt"] == VT_VISUAL) & ~prog["is_new"])}
                if pwins != wins:
                    if _bestfit_tie(w, vslack, eligible, wins, pwins):
                        wins, tie_visual = pwins, True
                    else:
                        refused += len({r for r in set(wins) | set(pwins)
                                        if wins.get(r) != pwins.get(r)})
        claimed = np.zeros(t, bool)
        claimed[list(wins.values())] = True
        row_open = valid & ~has_any
        col_open = self.active & ~claimed
        pvalid = pvalid & row_open[:, None] & col_open[None]
        open_rows = set(np.flatnonzero(row_open).tolist())
        ref = optimal_matches(np.where(pvalid, P, 0.0), thr)
        tie = False
        if prog is not None:
            pos = valid & ~prog["is_new"]
            if self.visual:
                pos &= prog["vt"] == VT_POSITIONAL
            pmatch = {int(r): int(prog["slots"][r]) for r in np.flatnonzero(pos)}
            # the program may compute a pair just over the threshold that
            # falls just under it here: judge its pairs on the raw weights
            raw_valid = raw_ok & row_open[:, None] & col_open[None]
            use, tie, bad = self._check_program(
                P, raw_valid, thr, open_rows,
                set(np.flatnonzero(col_open).tolist()), ref, pmatch)
            refused += bad
            self.diag = dict(epoch=epoch, wins=wins, P=P, weight=weight,
                             optimum=ref, program=pmatch,
                             program_wins=pwins if self.visual else {})
            ref = use

        matched = np.zeros(d, bool)
        tgt = np.zeros(d, np.int64)
        vt = np.full(d, VT_POSITIONAL, np.int64)
        for r, c in wins.items():
            matched[r], tgt[r], vt[r] = True, c, VT_VISUAL
        for r, c in ref.items():
            matched[r], tgt[r] = True, c

        # slots: the r-th new row takes the r-th free slot (slot order)
        is_new = valid & ~matched
        new_rank = np.cumsum(is_new) - 1
        n_new = int(is_new.sum())
        free = np.flatnonzero(~self.active)
        overflow = n_new > len(free)
        nth = np.where(new_rank < len(free),
                       free[np.clip(new_rank, 0, max(len(free) - 1, 0))]
                       if len(free) else t - 1, t - 1)
        slot = np.where(matched, tgt, nth)
        safe = valid & (not overflow)

        pw, vw = s.position_weight, s.velocity_weight
        init = kf_initiate(box, pw, vw)
        prev = [np.where(matched[:, None], c[slot], i)
                for c, i in zip(self.kf, init)]
        st = kf_update(kf_predict(prev, pw, vw), box, pw)
        pred = st[0]
        new_length = np.where(matched, self.length[slot] + 1, 1)
        ids = np.where(matched, self.track_id[slot],
                       self.next_id + new_rank + 1)

        rows = np.flatnonzero(safe)
        ws = slot[rows]
        if self.visual:
            k = self.k
            gal_valid = matched[:, None] & self.fv[slot]
            gal_q = self.fq[slot]
            evict = gal_valid.sum(1) >= k
            evict_k = first_argmax(-np.where(gal_valid, gal_q, np.inf), 1)
            lanes = np.arange(k)
            gal_valid &= ~(evict[:, None] & (lanes[None] == evict_k[:, None]))
            keep_new = fvalid & (is_new | collect_gate)
            free_k = first_argmax((~gal_valid).astype(np.int64), 1)
            new_lane = (lanes[None] == free_k[:, None]) & keep_new[:, None]
            final_valid = gal_valid | new_lane
            final_q = np.where(new_lane, qual[:, None], gal_q)
            lane_rows = rows[keep_new[rows]]
            self.feats[slot[lane_rows], free_k[lane_rows]] = feat[lane_rows]
            self.fq[ws] = final_q[rows]
            self.fv[ws] = final_valid[rows]
            self.collected[ws] = final_valid[rows].sum(1)
            self.vtype[ws] = vt[rows]
            self.hist_feat[ws] = feat[rows]
            self.hist_fv[ws] = fvalid[rows]
        for c, v in zip(self.kf, st):
            c[ws] = v[rows]
        self.obs[ws] = box[rows]
        self.conf[ws] = conf[rows]
        self.active[ws] = True
        self.last_epoch[ws] = epoch
        self.length[ws] = new_length[rows]
        self.track_id[ws] = ids[rows]
        self.next_id += n_new
        if self.bf16:
            self.kf = [round_bf16(c) for c in self.kf]
            if self.visual:
                self.feats = round_bf16(self.feats)
                self.hist_feat = round_bf16(self.hist_feat)
            pred = round_bf16(pred)
        return StepResult(ids=ids, slots=slot, vt=vt, is_new=is_new,
                          pred=pred, tie=tie or tie_visual,
                          refused=refused)

    def state(self) -> Dict[str, np.ndarray]:
        """The state by the program's names (`SortState` / `VisualState`,
        history depth 1, the Kalman state's five parts)."""
        out = dict(active=self.active, last_epoch=self.last_epoch,
                   length=self.length, track_id=self.track_id,
                   mean_pos=self.kf[0], mean_vel=self.kf[1], cpp=self.kf[2],
                   cpv=self.kf[3], cvv=self.kf[4], pred_box=self.kf[0],
                   obs_box=self.obs, conf=self.conf)
        if self.visual:
            out.update(feats=self.feats, feat_valid=self.fv,
                       feat_quality=self.fq, collected=self.collected,
                       voting_type=self.vtype, hist_feat=self.hist_feat,
                       hist_feat_valid=self.hist_fv)
        return out
