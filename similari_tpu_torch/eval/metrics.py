"""CLEAR (MOTA/MOTP) + Identity (IDF1) metrics (mirrors
`similari_tpu/eval/metrics.py`: the same NumPy and scipy on the host, so
the results are equal).

Self-contained implementation of the metrics the reference computes through
`trackeval` in its MOTChallenge kit (`python/motchallenge/evaluator.py:28-36`,
CLEAR + Identity at threshold 0.5), so accuracy parity can be measured
without external dependencies.

Conventions follow trackeval: CLEAR matching prefers previous-frame
correspondences (score bonus) then maximizes IoU via Hungarian; Identity
solves a global trajectory-level assignment maximizing per-pair co-occurrence
counts.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

Frame = Dict[int, np.ndarray]  # frame -> [N, 5] (id, left, top, w, h)


def iou_matrix_ltwh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a[N,4], b[M,4] LTWH -> IoU [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(ax1[:, None], bx1[None, :])
    ih = np.minimum(ay2[:, None], by2[None, :]) - np.maximum(ay1[:, None], by1[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def clear_metrics(
    gt: Dict[int, List[Tuple[int, float, float, float, float]]],
    pred: Dict[int, List[Tuple[int, float, float, float, float]]],
    threshold: float = 0.5,
) -> Dict[str, float]:
    """CLEAR: MOTA, MOTP, TP/FP/FN/IDSW.  Rows: (id, left, top, w, h)."""
    frames = sorted(set(gt) | set(pred))
    tp = fp = fn = idsw = 0
    motp_sum = 0.0
    prev_match: Dict[int, int] = {}  # gt_id -> pred_id (last known)
    for f in frames:
        g = np.asarray(gt.get(f, []), np.float64).reshape(-1, 5)
        p = np.asarray(pred.get(f, []), np.float64).reshape(-1, 5)
        sim = iou_matrix_ltwh(g[:, 1:], p[:, 1:])
        score = sim.copy()
        # bonus keeps existing correspondences when still above threshold
        for i, gid in enumerate(g[:, 0].astype(np.int64)):
            pid = prev_match.get(int(gid))
            if pid is None:
                continue
            j = np.nonzero(p[:, 0].astype(np.int64) == pid)[0]
            if len(j) and sim[i, j[0]] >= threshold - 1e-9:
                score[i, j[0]] += 1000.0
        matches = []
        if score.size:
            rows, cols = linear_sum_assignment(score, maximize=True)
            for i, j in zip(rows, cols):
                if sim[i, j] >= threshold - 1e-9:
                    matches.append((i, j))
        tp += len(matches)
        fn += len(g) - len(matches)
        fp += len(p) - len(matches)
        for i, j in matches:
            gid = int(g[i, 0])
            pid = int(p[j, 0])
            if gid in prev_match and prev_match[gid] != pid:
                idsw += 1
            prev_match[gid] = pid
            motp_sum += sim[i, j]
    num_gt = sum(len(v) for v in gt.values())
    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = motp_sum / max(tp, 1)
    return {
        "MOTA": mota,
        "MOTP": motp,
        "TP": tp,
        "FP": fp,
        "FN": fn,
        "IDSW": idsw,
        "GT": num_gt,
    }


def identity_metrics(
    gt: Dict[int, List[Tuple[int, float, float, float, float]]],
    pred: Dict[int, List[Tuple[int, float, float, float, float]]],
    threshold: float = 0.5,
) -> Dict[str, float]:
    """Identity metrics (Ristani et al.): IDF1/IDP/IDR via global LAP."""
    pair_counts: Dict[Tuple[int, int], int] = defaultdict(int)
    gt_counts: Dict[int, int] = defaultdict(int)
    pred_counts: Dict[int, int] = defaultdict(int)
    frames = sorted(set(gt) | set(pred))
    for f in frames:
        g = np.asarray(gt.get(f, []), np.float64).reshape(-1, 5)
        p = np.asarray(pred.get(f, []), np.float64).reshape(-1, 5)
        for gid in g[:, 0].astype(np.int64):
            gt_counts[int(gid)] += 1
        for pid in p[:, 0].astype(np.int64):
            pred_counts[int(pid)] += 1
        sim = iou_matrix_ltwh(g[:, 1:], p[:, 1:])
        ii, jj = np.nonzero(sim >= threshold - 1e-9)
        for i, j in zip(ii, jj):
            pair_counts[(int(g[i, 0]), int(p[j, 0]))] += 1

    gids = sorted(gt_counts)
    pids = sorted(pred_counts)
    gidx = {g: i for i, g in enumerate(gids)}
    pidx = {p: i for i, p in enumerate(pids)}
    C = np.zeros((len(gids), len(pids)))
    for (g_, p_), c in pair_counts.items():
        C[gidx[g_], pidx[p_]] = c
    idtp = 0.0
    if C.size:
        rows, cols = linear_sum_assignment(C, maximize=True)
        idtp = float(C[rows, cols].sum())
    num_gt = sum(gt_counts.values())
    num_pred = sum(pred_counts.values())
    idf1 = 2.0 * idtp / max(num_gt + num_pred, 1)
    idp = idtp / max(num_pred, 1)
    idr = idtp / max(num_gt, 1)
    return {"IDF1": idf1, "IDP": idp, "IDR": idr, "IDTP": idtp}
