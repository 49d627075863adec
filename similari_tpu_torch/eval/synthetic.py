"""Synthetic MOT sequence generator for accuracy evaluation (mirrors
`similari_tpu/eval/synthetic.py`: the same NumPy, so the same seed gives
the same arrays bit for bit).

No MOT17/MOT20 data ships with the repository, so accuracy is
exercised on synthetic scenes with known ground truth: random-walk objects
with birth/death windows, detector noise, dropouts, and false positives —
the same knobs that differentiate trackers on real MOT data.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

GT = Dict[int, List[Tuple[int, float, float, float, float]]]
Dets = Dict[int, List[Tuple[float, float, float, float, float]]]


def generate_sequence(
    n_objects: int = 20,
    n_frames: int = 100,
    arena: float = 800.0,
    seed: int = 0,
    pos_noise: float = 1.0,
    wh_noise: float = 0.5,
    p_miss: float = 0.05,
    fp_per_frame: float = 0.5,
    birth_death: bool = True,
    feature_dim: int = 0,
    feature_noise: float = 0.05,
) -> Tuple[GT, Dets]:
    """When feature_dim > 0 also returns per-frame ReID features aligned with
    detections: (gt, dets, feats) — identity embeddings + noise, random
    embeddings for false positives."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(50, arena - 50, size=(n_objects, 2))
    vel = rng.uniform(-3, 3, size=(n_objects, 2))
    wh = rng.uniform(25, 55, size=(n_objects, 2))
    if birth_death:
        birth = rng.integers(0, n_frames // 3, size=n_objects)
        death = rng.integers(2 * n_frames // 3, n_frames, size=n_objects)
    else:
        birth = np.zeros(n_objects, int)
        death = np.full(n_objects, n_frames - 1)

    if feature_dim:
        identities = rng.normal(size=(n_objects, feature_dim)) * 2.0
    gt: GT = {}
    dets: Dets = {}
    feats: Dict[int, List] = {}
    for f in range(n_frames):
        xy += vel + rng.normal(0, 0.3, size=xy.shape)
        vel = np.clip(vel + rng.normal(0, 0.2, size=vel.shape), -4, 4)
        # bounce off walls
        for d in range(2):
            low = xy[:, d] < 30
            high = xy[:, d] > arena - 30
            vel[low, d] = np.abs(vel[low, d])
            vel[high, d] = -np.abs(vel[high, d])
        gt_rows = []
        det_rows = []
        feat_rows = []
        for i in range(n_objects):
            if not (birth[i] <= f <= death[i]):
                continue
            l = xy[i, 0] - wh[i, 0] / 2
            t = xy[i, 1] - wh[i, 1] / 2
            gt_rows.append((i + 1, l, t, wh[i, 0], wh[i, 1]))
            if rng.uniform() < p_miss:
                continue
            if feature_dim:
                feat_rows.append(
                    (identities[i] + rng.normal(size=feature_dim) * feature_noise)
                    .astype(np.float32)
                )
            det_rows.append(
                (
                    l + rng.normal(0, pos_noise),
                    t + rng.normal(0, pos_noise),
                    max(5.0, wh[i, 0] + rng.normal(0, wh_noise)),
                    max(5.0, wh[i, 1] + rng.normal(0, wh_noise)),
                    float(np.clip(rng.normal(0.9, 0.05), 0.1, 1.0)),
                )
            )
        # false positives
        n_fp = rng.poisson(fp_per_frame)
        for _ in range(n_fp):
            if feature_dim:
                feat_rows.append(rng.normal(size=feature_dim).astype(np.float32) * 2.0)
            det_rows.append(
                (
                    rng.uniform(0, arena),
                    rng.uniform(0, arena),
                    rng.uniform(20, 50),
                    rng.uniform(20, 50),
                    float(np.clip(rng.normal(0.5, 0.2), 0.1, 1.0)),
                )
            )
        gt[f + 1] = gt_rows
        if det_rows:
            dets[f + 1] = det_rows
            if feature_dim:
                feats[f + 1] = feat_rows
    if feature_dim:
        return gt, dets, feats
    return gt, dets


def generate_adversarial_sequence(scenario: str, seed: int = 0,
                                  n_frames: int = 120):
    """Adversarial scenarios for the accuracy-delta suite.  Each returns (gt, dets) shaped like `generate_sequence`.

    Scenarios:
      crossing  — two columns of targets walk through each other (sustained
                  mutual proximity; the classic id-switch generator).
                  The geometry is tightened until the solvers can
                  actually disagree: sigma=3 px detector noise on 34-px
                  boxes and passes within ~5 px — the cost matrices carry
                  genuine near-ties during the cross and every axis pays
                  id-switches (absolute MOTA/IDF1 < 100); the suite then
                  certifies the *deltas* between axes stay tiny.
      fp_burst  — clean tracking with a mid-sequence burst of ~12 false
                  positives per frame for 20 frames
      idle_gaps — every object vanishes for a window of 2-7 frames
                  (straddling max_idle_epochs=5: some gaps re-identify,
                  some legitimately terminate)
      churn     — heavy birth/death plus 15% detector misses
      capacity  — 120 objects with churn (pressure for small stores and
                  recycle_idle)
    """
    rng = np.random.default_rng(seed)
    if scenario == "crossing":
        return _crossing_geometry(rng, n_frames=n_frames, n_pairs=16,
                                  pos_noise=3.0, pass_offset=5.0)
    if scenario == "fp_burst":
        gt, dets = generate_sequence(
            n_objects=20, n_frames=n_frames, seed=seed, p_miss=0.02,
            fp_per_frame=0.2, birth_death=False)
        for f in range(50, 70):
            rows = dets.setdefault(f + 1, [])
            for _ in range(12):
                rows.append((rng.uniform(0, 800), rng.uniform(0, 800),
                             rng.uniform(20, 50), rng.uniform(20, 50),
                             float(np.clip(rng.normal(0.6, 0.2), 0.1, 1.0))))
        return gt, dets
    if scenario == "idle_gaps":
        gt, dets = generate_sequence(
            n_objects=16, n_frames=n_frames, seed=seed, p_miss=0.0,
            fp_per_frame=0.0, birth_death=False)
        # carve per-object occlusion windows out of the detections (gt keeps
        # the object: missing it costs FN, a late re-identify costs IDSW).
        # With p_miss=0 and no FPs, dets[f][k] aligns with gt[f][k] by
        # construction, so windows apply by index.
        windows = {}
        for i in range(16):
            start = int(rng.integers(20, n_frames - 20))
            gap = int(rng.integers(2, 8))  # 2-7 frames vs max_idle_epochs=5
            windows[i + 1] = (start, start + gap)
        for f in list(dets):
            kept = []
            for k, d in enumerate(dets[f]):
                oid = gt[f][k][0]
                a, b = windows.get(oid, (0, 0))
                if a <= f < b:
                    continue
                kept.append(d)
            dets[f] = kept
        return gt, dets
    if scenario == "churn":
        return generate_sequence(
            n_objects=40, n_frames=n_frames, seed=seed, p_miss=0.15,
            fp_per_frame=2.0, birth_death=True)
    if scenario == "capacity":
        return generate_sequence(
            n_objects=120, n_frames=n_frames, arena=2000.0, seed=seed,
            p_miss=0.1, fp_per_frame=3.0, birth_death=True)
    raise ValueError(f"unknown scenario {scenario!r}")


def _crossing_geometry(rng, n_frames: int, n_pairs: int, pos_noise: float,
                       pass_offset: float, speed: float = 3.5,
                       box: float = 34.0, oriented: bool = False):
    """Two columns of targets walking through each other.

    Each pair shares a row; the two members pass within `pass_offset` px
    vertically, so during the cross the IoU cost matrix has genuine
    near-ties (with pos_noise ~ 3 px the noisy detections are ambiguous
    for several frames).  The columns bounce off the arena walls so a long
    sequence produces SEVERAL crossing events.  When `oriented`, boxes
    carry a slowly-varying angle (exercises the rotated clip kernels).
    """
    n = 2 * n_pairs
    gt: GT = {}
    dets: Dets = {}
    arena = 800.0
    y0 = np.linspace(60, arena - 60, n_pairs)
    x = np.empty((n,), np.float64)
    v = np.empty((n,), np.float64)
    x[0::2], v[0::2] = 100.0, speed
    x[1::2], v[1::2] = arena - 100.0, -speed
    ang0 = rng.uniform(0, 0.5, size=n) if oriented else np.zeros(n)
    for f in range(n_frames):
        x += v
        bounce_lo = x < 50.0
        bounce_hi = x > arena - 50.0
        v[bounce_lo] = np.abs(v[bounce_lo])
        v[bounce_hi] = -np.abs(v[bounce_hi])
        gt_rows, det_rows = [], []
        for j in range(n):
            y = y0[j // 2] + (pass_offset if j % 2 else -pass_offset)
            l, t = x[j] - box / 2, y - box / 2
            gt_rows.append((j + 1, l, t, box, box))
            ang = ang0[j] + (0.003 * f if oriented else 0.0)
            det_rows.append((l + rng.normal(0, pos_noise),
                             t + rng.normal(0, pos_noise),
                             box, box, 0.9, ang))
        gt[f + 1] = gt_rows
        dets[f + 1] = [r[:5] for r in det_rows] if not oriented else det_rows
    return gt, dets


def generate_reid_adversarial_sequence(scenario: str, seed: int = 0,
                                       n_frames: int = 240,
                                       feature_dim: int = 128):
    """Feature-augmented adversarial scenarios for the VisualSORT accuracy
    axes.  Returns (gt, dets, feats, quals) where
    `feats[frame][i]` / `quals[frame][i]` align with `dets[frame][i]`
    (feats entries may be None = no ReID for that detection).

    Scenarios model the regime of the reference's recorded VisualSort
    accuracy regression (the reference's `python/bugfixes/bug_vs_1/`):
    identity embeddings that DRIFT over time, plus occlusion-correlated
    corruption — while two targets overlap, their crops mix, so the
    feature blends both identities and the reported quality drops.

      reid_crossing  — the tightened crossing geometry + drifting features
                       with occlusion-mixed embeddings and low quality
                       during the cross (ReID must carry identity through
                       the positional ambiguity, on degraded features)
      reid_gaps      — occlusion windows of 2-9 frames with NO detection
                       (vs max_idle_epochs) + feature drift: re-identify
                       on reappearance rides the gallery
      reid_oriented  — reid_crossing with rotating boxes (oriented clip
                       kernels inside the visual cascade)
      reid_confusable — crossing with CORRELATED identities: every
                       embedding shares a dominant common component, so
                       cross-identity cosine sits near the 0.5 use-gate
                       and same-identity (drifted, occlusion-mixed)
                       features are barely above it — the decision
                       margins shrink to the scale of the bf16 gallery
                       quantization and solver tie-breaks, which is what
                       lets the engine axes actually diverge
    """
    rng = np.random.default_rng(seed + 1000)
    oriented = scenario == "reid_oriented"
    if scenario in ("reid_crossing", "reid_oriented", "reid_confusable"):
        gt, dets = _crossing_geometry(
            rng, n_frames=n_frames, n_pairs=16, pos_noise=3.0,
            pass_offset=5.0, oriented=oriented)
        n = 32
    elif scenario == "reid_gaps":
        gt, dets = generate_sequence(
            n_objects=24, n_frames=n_frames, seed=seed, p_miss=0.0,
            fp_per_frame=0.0, birth_death=False, pos_noise=2.0)
        n = 24
        windows = {}
        for i in range(n):
            start = int(rng.integers(20, n_frames - 20))
            gap = int(rng.integers(2, 10))
            windows[i + 1] = (start, start + gap)
        for f in list(dets):
            kept = []
            for k, d in enumerate(dets[f]):
                oid = gt[f][k][0]
                a, b = windows.get(oid, (0, 0))
                if a <= f < b:
                    continue
                kept.append((oid, d))
            dets[f] = kept  # temporarily (oid, det); unpacked below
    else:
        raise ValueError(f"unknown reid scenario {scenario!r}")

    identities = rng.normal(size=(n, feature_dim)).astype(np.float64)
    identities /= np.linalg.norm(identities, axis=1, keepdims=True)
    if scenario == "reid_confusable":
        # shared dominant component: cross-identity cosine ~ 1/(1+c^2)
        # with c = 1 -> ~0.5, i.e. AT the use-gate threshold
        common = rng.normal(size=feature_dim)
        common /= np.linalg.norm(common)
        identities = common[None, :] + 1.0 * identities
        identities /= np.linalg.norm(identities, axis=1, keepdims=True)
    drift = rng.normal(size=(n, feature_dim)) * 0.004  # per-frame walk
    feats: Dict[int, List] = {}
    quals: Dict[int, List] = {}
    cur = identities.copy()
    for f in sorted(dets):
        cur = cur + drift + rng.normal(size=cur.shape) * 0.002
        cur /= np.linalg.norm(cur, axis=1, keepdims=True)
        rows = dets[f]
        if scenario == "reid_gaps":
            oids = [r[0] for r in rows]
            dets[f] = [r[1] for r in rows]
            rows = dets[f]
        else:
            oids = [g[0] for g in gt[f]]  # aligned by construction
        # occlusion mixing: per-pair overlap from the GT geometry
        centers = np.array([[d[0] + d[2] / 2, d[1] + d[3] / 2] for d in rows])
        sizes = np.array([max(d[2], d[3]) for d in rows])
        frow, qrow = [], []
        for i, oid in enumerate(oids):
            base = cur[oid - 1]
            if len(rows) > 1:
                dist = np.linalg.norm(centers - centers[i], axis=1)
                dist[i] = np.inf
                jn = int(np.argmin(dist))
                overlap = max(0.0, 1.0 - dist[jn] / max(sizes[i], 1.0))
            else:
                overlap = 0.0
            if overlap > 0.0:
                other = cur[oids[jn] - 1]
                mix = 0.6 * overlap
                fv = (1.0 - mix) * base + mix * other
                fv /= max(np.linalg.norm(fv), 1e-9)
                q = float(np.clip(0.95 - 0.8 * overlap
                                  + rng.normal(0, 0.03), 0.05, 1.0))
            else:
                fv = base
                q = float(np.clip(rng.normal(0.92, 0.04), 0.5, 1.0))
            fv = fv + rng.normal(size=feature_dim) * 0.02
            frow.append(fv.astype(np.float32))
            qrow.append(q)
        feats[f] = frow
        quals[f] = qrow
    return gt, dets, feats, quals
