"""MOTChallenge evaluation orchestration (mirrors
`similari_tpu/motchallenge/evaluator.py`).

As the reference kit's `python/motchallenge/{__main__,evaluator}.py`: run
a tracker over each sequence directory (MOT layout: `<seq>/det/det.txt`,
`<seq>/gt/gt.txt`), write MOT-format results + processing_stats.csv, and
score CLEAR + Identity at threshold 0.5 with the built-in metrics (the
reference shells out to trackeval in docker).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..device import DeviceLike
from ..eval.metrics import clear_metrics, identity_metrics
from ..eval.mot import read_detections, read_gt, write_csv
from .trackers import SimilariTPUSort, Tracker


def run_sequence(tracker: Tracker, detections) -> Dict[int, List]:
    out: Dict[int, List] = {}
    frames = sorted(detections)
    if not frames:  # empty det file: nothing to track, nothing to crash on
        return out
    lo, hi = frames[0], frames[-1]
    for frame in range(lo, hi + 1):
        rows = tracker.process_frame(frame, detections.get(frame, []))
        out[frame] = [(tid, l, t, w, h) for tid, l, t, w, h, _conf in rows]
    return out


def evaluate_sequences(
    data_path,
    make_tracker: Callable[[], Tracker],
    output_path: Optional[Path] = None,
    threshold: float = 0.5,
) -> Dict[str, Dict[str, float]]:
    """Evaluate every sequence dir under data_path; returns per-seq metrics."""
    data_path = Path(data_path)
    results: Dict[str, Dict[str, float]] = {}
    stats_rows = [("sequence", "frames", "avg_dets", "fps")]
    for seq in sorted(p for p in data_path.iterdir() if p.is_dir()):
        det_file = seq / "det" / "det.txt"
        gt_file = seq / "gt" / "gt.txt"
        if not det_file.exists():
            continue
        detections = read_detections(det_file)
        tracker = make_tracker()
        t0 = time.perf_counter()
        pred = run_sequence(tracker, detections)
        dt = time.perf_counter() - t0
        n_frames = len(pred)
        avg_dets = sum(len(v) for v in detections.values()) / max(len(detections), 1)
        fps = n_frames / dt if dt > 0 else 0.0
        stats_rows.append((seq.name, n_frames, round(avg_dets, 1), round(fps, 2)))

        if output_path is not None:
            out_dir = Path(output_path)
            out_dir.mkdir(parents=True, exist_ok=True)
            rows = []
            for frame in sorted(pred):
                for tid, l, t, w, h in pred[frame]:
                    rows.append((frame, tid, round(l, 2), round(t, 2),
                                 round(w, 2), round(h, 2), 1, -1, -1, -1))
            write_csv(out_dir / f"{seq.name}.txt", rows)

        if gt_file.exists():
            gt = read_gt(gt_file)
            m = clear_metrics(gt, pred, threshold)
            m.update(identity_metrics(gt, pred, threshold))
            results[seq.name] = m
    if output_path is not None:
        write_csv(Path(output_path) / "processing_stats.csv", stats_rows)
    return results


def run_and_evaluate(data_path, output_path=None, method: str = "iou",
                     device: DeviceLike = None):
    return evaluate_sequences(
        data_path, lambda: SimilariTPUSort(method=method, device=device),
        output_path)
