"""Per-call API latency of the port: the reference's own benchmark shape.

Run: python -m similari_tpu_torch.bench_interactive [--engine host|device]
     [--device cuda|cpu] [--objects N ...] [--reps N] [--captures N]

The reference's published Python numbers are per-call `Sort.predict`
latencies (api.md:250-269: 0.149 ms at 10 objects ... 53.1 ms at 1000,
single stream, warm process).  This script measures the same per-call
point for the port's public API, with the rows, widths, seeds and
reference tables of the JAX package's `bench_interactive.py`.

`--engine` picks where the trackers, the generic store and the own-area
shares run: "host" (the default, the engine the JAX script measures: the
C++ SORT / VisualSORT steps, the store and the own-area kernel on the
CPU) or "device" (the general steps, the store's feature index and the
own-area kernel on `--device`).  The port's `engine="auto"` means the
device, so the engine is always passed explicitly.  `FeatureTracker` and
the Kalman filter API run on the host under both engines, as in the
reference.  Rows on the card are timed with CUDA events, host rows with
the host clock.  `--device` is CUDA unless `--device cpu` is given; without
CUDA the script raises before it measures anything.

Each row is the median of `--reps` warm calls (the first calls of a
tracker are warm-up and not timed); `--captures` independent captures
give per-row medians and their spread.

Output: a table on stderr, one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import (BatchSort, BoundingBox, FeatureTracker, Point2DKalmanFilter,
               PositionalMetricType, Sort, SortPredictionBatchRequest,
               SpatioTemporalConstraints, Universal2DBox,
               Universal2DBoxKalmanFilter, VisualSort, VisualSortMetricType,
               VisualSortOptions)
from .core.examples import (BatchedSimpleMetric, SimpleAttributeUpdate,
                            SimpleAttrs)
from .core.store import TrackStoreBuilder
from .core.track import ObservationBuilder
from .device import resolve_device
from .eval.mot import DeviceTimer
from .ops.ownarea import own_area_shares
from .utils.clipping import exclusively_owned_areas_normalized_shares

# ms/prediction from api.md:250-257 (Similari) and :262-269 (abewley/sort)
REFERENCE_MS = {10: 0.149, 100: 1.660, 200: 4.895, 300: 8.991, 500: 17.432,
                1000: 53.098}
ABEWLEY_MS = {10: 1.588, 100: 11.976, 200: 25.160, 300: 40.922, 500: 74.254,
              1000: 162.037}
# oriented SORT cargo-bench per-iter rows, benchmarks.md:48-52
ORIENTED_REF_MS = {10: 0.108414, 100: 1.601062, 500: 18.945655}
# generic feature engine (256-d, gallery 3), benchmarks.md:82-86
FEATURE_REF_MS = {10: 0.101465, 100: 4.020673, 500: 61.716729}
# VisualSORT per-call (512-d, gallery<=5), benchmarks.md:93-109 (ns/iter)
VISUAL_REF_MS = {10: 0.447903, 50: 2.249694, 100: 5.775469}
# BatchSORT per-call (one scene x N), benchmarks.md:116-120 (IoU) and
# :127-131 (Maha)
BATCH_REF_MS = {10: 0.106876, 100: 1.616542, 500: 20.454230}
BATCH_MAHA_REF_MS = {10: 0.114592, 100: 1.533445, 500: 18.270742}
# the rows given beside their reference in the output's vs_reference
REFS = {"visual": VISUAL_REF_MS, "feature": FEATURE_REF_MS,
        "sort_oriented": ORIENTED_REF_MS, "batch_sort": BATCH_REF_MS}
KALMAN_STEPS = 100_000
ENGINES = ("host", "device")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them; "cpu"
    for a run on the host."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.splitlines()[dev.index or 0].strip()


def call_ms(dev: torch.device, fn) -> float:
    """One call's ms: CUDA events on the card, the host clock on the CPU."""
    with DeviceTimer(dev) as timer:
        fn()
    return timer.seconds * 1e3


def median_ms(dev, fn, inputs) -> float:
    return statistics.median(call_ms(dev, lambda: fn(x)) for x in inputs)


def case_ms(dev, case, reps: int, frames_in_call: bool = False) -> float:
    """Median ms of `reps` calls of a warm `case` = (call, frame): the
    frames made before the timed calls, or inside each timed call
    (`frames_in_call`, the JAX `bench.py`'s host rows)."""
    call, frame = case
    if frames_in_call:
        return statistics.median(call_ms(dev, lambda: call(frame()))
                                 for _ in range(reps))
    return median_ms(dev, call, [frame() for _ in range(reps)])


# The rows' workloads, shared with bench.py's host rows.  Each builds its
# tracker, warms it with 5 calls (the store at steady state) and returns
# (call, frame): `call(frame())` is one timed request.

def sort_case(n, engine, dev, oriented=False, draws_angles=False):
    """`Sort` (IoU 0.3) over a random walk of `n` boxes, seed 1; oriented
    boxes keep fixed angles in [0, 1).  The angles are drawn for aligned
    rows too where `draws_angles` (the JAX bench.py's host rows)."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, (n, 2)).astype(np.float32)
    if oriented or draws_angles:
        ang = rng.uniform(0, 1.0, (n,)).astype(np.float32)
    tracker = Sort(shards=1, bbox_history=1, max_idle_epochs=5,
                   method=PositionalMetricType.iou(0.3), engine=engine,
                   device=dev)

    def frame():
        nonlocal xy
        xy = xy + rng.uniform(-2, 2, xy.shape).astype(np.float32)
        boxes = np.zeros((n, 5), np.float32)
        boxes[:, :2] = xy
        if oriented:
            boxes[:, 2] = ang
        boxes[:, 3] = wh[:, 0] / wh[:, 1]
        boxes[:, 4] = wh[:, 1]
        return boxes, np.ones((n,), np.float32)

    def call(f):
        tracker.predict_arrays(0, *f)

    for _ in range(5):
        call(frame())
    return call, frame


def feature_case(n, **tracker_kwargs):
    """`FeatureTracker` (256-d, gallery 3; the host) over `n` drifting
    vectors, seed 2: the reference's benches/feature_tracker.rs:95-170."""
    rng = np.random.default_rng(2)
    base = np.zeros((n, 256), np.float32)
    base[:, 0] = 1000.0 * np.arange(n)
    tracker = FeatureTracker(256, gallery=3, **tracker_kwargs)

    def epoch():
        nonlocal base
        base = base + rng.uniform(-0.1, 0.1, base.shape).astype(np.float32)
        return base

    for _ in range(5):
        tracker.predict(epoch())
    return tracker.predict, epoch


def visual_case(n, engine, dev):
    """`VisualSort` (512-d, euclidean 10, IoU 0.3) on the array fast path
    (`predict_arrays`: no per-observation Python objects in the timed
    call), `n` identities with noisy features, seed 3."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 600 * np.sqrt(n / 10), (n, 2)).astype(np.float32)
    ident = rng.normal(size=(n, 512)).astype(np.float32)
    opts = VisualSortOptions()
    opts.visual_metric(VisualSortMetricType.euclidean(10.0))
    opts.positional_metric(PositionalMetricType.iou(0.3))
    opts.visual_minimal_track_length(2)
    opts.max_idle_epochs(5)
    tracker = VisualSort(1, opts, engine=engine, device=dev)

    def frame():
        nonlocal xy
        xy = xy + rng.uniform(-2, 2, xy.shape).astype(np.float32)
        box = np.zeros((n, 5), np.float32)
        box[:, :2] = xy
        box[:, 3] = 0.5
        box[:, 4] = 40.0
        feat = ident + rng.normal(
            scale=0.05, size=(n, 512)).astype(np.float32)
        return (box, np.ones((n,), np.float32), feat,
                np.ones((n,), bool), np.full((n,), 0.9, np.float32))

    def call(f):
        tracker.predict_arrays(0, *f)

    for _ in range(5):
        call(frame())
    return call, frame


def batch_case(kind, n, engine, dev):
    """`BatchSort` at the reference's per-call shape: one scene x `n`
    objects a request, constraint (1, 1.0), seed 4; the request build is
    timed, as in the reference's benches/batch_sort_iou_tracker.rs."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 1000.0 * n, (n, 2)).astype(np.float32)
    stc = SpatioTemporalConstraints()
    stc.add_constraints([(1, 1.0)])
    tracker = BatchSort(1, 1, bbox_history=10, max_idle_epochs=1,
                        method=(PositionalMetricType.iou(0.3) if kind == "iou"
                                else PositionalMetricType.maha()),
                        spatio_temporal_constraints=stc, engine=engine,
                        device=dev)

    def frame():
        nonlocal xy
        xy = xy + rng.uniform(-1, 1, xy.shape).astype(np.float32)
        return [BoundingBox(float(xy[i, 0]), float(xy[i, 1]),
                            50.0, 50.0).as_xyaah() for i in range(n)]

    def call(boxes):
        req = SortPredictionBatchRequest()
        for i, bb in enumerate(boxes):
            req.add(0, bb, i)
        res = tracker.predict(req)
        for _ in range(res.batch_size()):
            res.get()

    for _ in range(5):
        call(frame())
    return call, frame


def measure(args):
    """One full capture: every row measured once (internal per-row medians
    over `--reps` warm calls).  Returns the rows dict."""
    dev = resolve_device(args.device)
    engine = args.engine
    # where the trackers, the store and the own-area kernel run
    place = dev if engine == "device" else torch.device("cpu")
    host = torch.device("cpu")
    log(f"engine={engine} on {place} (per-call latency, warm path)")
    rows = {}
    for n in args.objects:
        ms = case_ms(place, sort_case(n, engine, dev), args.reps)
        rows[f"sort_{n}_ms"] = round(ms, 3)
        ref = REFERENCE_MS.get(n)
        ab = ABEWLEY_MS.get(n)
        cmp = (f"  reference {ref:.3f} ms [x{ref / ms:.2f}], "
               f"abewley {ab:.3f} ms [x{ab / ms:.2f}]" if ref else "")
        log(f"{n:5d} objects: {ms:8.3f} ms/predict ({1e3 / ms:8.1f} FPS){cmp}")

    def row(key, tag, n, ms, ref):
        rows[key] = round(ms, 3)
        log(f"{tag} {n:4d} objects: {ms:8.3f} ms/predict "
            f"({1e3 / ms:8.1f} FPS)  reference {ref:.3f} ms [x{ref/ms:.2f}]")

    for n in (10, 100, 500):
        row(f"sort_oriented_{n}_ms", "ornt", n,
            case_ms(place, sort_case(n, engine, dev, oriented=True),
                    args.reps), ORIENTED_REF_MS[n])

    # FeatureTracker runs on the host under both engines
    for n in (10, 100, 500):
        row(f"feature_{n}_ms", "feat", n,
            case_ms(host, feature_case(n, max_distance=100.0, min_votes=1),
                    args.reps), FEATURE_REF_MS[n])

    # ---- generic store search (the reference's benches/simple_search.rs +
    # track_search.rs workloads; no published numbers, so the rows record
    # the port's latency at the reference's shapes) ------------------------
    def store_query_ms(vec_len, count, track_len=1, use_arrays=False,
                       reps=20):
        rng = np.random.default_rng(5)
        db = (TrackStoreBuilder(4, device=place)
              .default_attributes(SimpleAttrs())
              .metric(BatchedSimpleMetric()).build())
        for i in range(count):
            for k in range(track_len):
                db.add(i, 0, 1.0,
                       rng.uniform(0, 1, vec_len).astype(np.float32),
                       SimpleAttributeUpdate() if k == 0 else None)

        def make_cand():
            b = db.new_track(count + 1)
            for k in range(track_len):
                ob = (ObservationBuilder(0).observation_attributes(1.0)
                      .observation(rng.uniform(0, 1, vec_len)
                                   .astype(np.float32)))
                if k == 0:  # SimpleAttrs update is one-shot
                    ob = ob.track_attributes_update(SimpleAttributeUpdate())
                b.observation(ob.build())
            return b.build()

        cand = make_cand()
        if use_arrays:
            db.foreign_track_distances_arrays(cand, 0, True)  # build index

        def query(_):
            if use_arrays:
                db.foreign_track_distances_arrays(cand, 0, True)
            else:
                _, errs = db.foreign_track_distances([cand], 0, True)
                if errs:
                    raise RuntimeError(f"store query failed: {errs}")

        # the setup loop allocates `count` track object graphs: collect them
        # before the timed calls, then freeze the survivors out of the
        # collector, or a generational pass over the setup heap lands
        # inside a timed call (the JAX script's serving posture)
        gc.collect()
        gc.freeze()
        try:
            return median_ms(place, query, range(reps))
        finally:
            gc.unfreeze()

    for vec_len, count in ((128, 1000), (128, 10000), (512, 1000),
                           (512, 10000)):
        ms_rec = store_query_ms(vec_len, count, reps=15 if count >= 10000
                                else 20)
        ms_arr = store_query_ms(vec_len, count, use_arrays=True)
        rows[f"store_search_{vec_len}_{count}_ms"] = round(ms_rec, 3)
        rows[f"store_search_{vec_len}_{count}_arrays_ms"] = round(ms_arr, 3)
        log(f"store {vec_len:4d}-d x {count:6d} tracks: {ms_rec:8.3f} ms "
            f"records / {ms_arr:7.3f} ms arrays per query")
    ms_rec = store_query_ms(256, 100, track_len=30, reps=10)
    ms_arr = store_query_ms(256, 100, track_len=30, use_arrays=True)
    rows["track_search_256_30_100_ms"] = round(ms_rec, 3)
    rows["track_search_256_30_100_arrays_ms"] = round(ms_arr, 3)
    log(f"track search 256-d x 30 obs x 100 tracks: {ms_rec:.3f} ms records"
        f" / {ms_arr:.3f} ms arrays")

    # ---- Kalman filter API (host; the reference's benches/kalman_bbox.rs,
    # kalman_2d_point.rs: no published numbers) -----------------------------
    kf = Universal2DBoxKalmanFilter()
    rng = np.random.default_rng(6)
    st = kf.initiate(Universal2DBox(0.0, 0.0, 0.0, 2.0, 5.0))
    zs = rng.normal(size=(KALMAN_STEPS, 2)).astype(np.float32)
    t0 = time.perf_counter()
    for i in range(KALMAN_STEPS):
        st = kf.predict(st)
        st = kf.update(st, Universal2DBox(
            float(zs[i, 0]), float(zs[i, 1]), 0.0, 2.0, 5.0))
    rows["kalman_bbox_100k_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    log(f"kalman bbox 100k predict/update: {rows['kalman_bbox_100k_ms']} ms"
        " (reference bench exists, no published number)")
    seq = np.zeros((KALMAN_STEPS, 5), np.float32)
    seq[:, 0] = zs[:, 0]
    seq[:, 1] = zs[:, 1]
    seq[:, 3] = 2.0
    seq[:, 4] = 5.0
    kf.filter_sequence(seq[:100])  # warm (builds the host library)
    t0 = time.perf_counter()
    kf.filter_sequence(seq)
    rows["kalman_bbox_100k_bulk_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 2)
    log(f"kalman bbox 100k bulk filter_sequence: "
        f"{rows['kalman_bbox_100k_bulk_ms']} ms")

    pkf = Point2DKalmanFilter()
    ps = pkf.initiate(0.0, 0.0)
    t0 = time.perf_counter()
    for i in range(KALMAN_STEPS):
        ps = pkf.predict(ps)
        ps = pkf.update(ps, float(zs[i, 0]), float(zs[i, 1]))
    rows["kalman_point_100k_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    log(f"kalman point 100k predict/update: {rows['kalman_point_100k_ms']} ms")
    pkf.filter_sequence(zs[:100])  # warm
    t0 = time.perf_counter()
    pkf.filter_sequence(zs)
    rows["kalman_point_100k_bulk_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 2)
    log(f"kalman point 100k bulk filter_sequence: "
        f"{rows['kalman_point_100k_bulk_ms']} ms")

    # ---- own-area shares (the reference's benches/bbox_own_areas.rs) ------
    # the tensor kernel (ops/ownarea.py, the visual step's gate) on the
    # engine's device; the host f64 polygon oracle (utils/clipping.py) is
    # the exactness reference, measured only at n=10 for the record
    for n in (10, 25, 50, 100):
        rng = np.random.default_rng(7)
        boxes = [
            Universal2DBox(float(i + rng.uniform(0, 20)),
                           float(i + rng.uniform(0, 20)), 0.0, 1.0,
                           float(10 + rng.uniform(0, 5)))
            for i in range(n)
        ]
        vec = np.asarray([[b.xc, b.yc, 0.0, b.aspect, b.height]
                          for b in boxes], np.float32)
        bt = torch.as_tensor(vec, device=place)
        vt = torch.ones((n,), dtype=torch.bool, device=place)
        own_area_shares(bt, vt, order=3, neighbors=8)  # warm
        reps_oa = 20
        with DeviceTimer(place) as timer:
            for _ in range(reps_oa):
                own_area_shares(bt, vt, order=3, neighbors=8)
        rows[f"own_areas_{n}_ms"] = round(timer.seconds / reps_oa * 1e3, 3)
        if n == 10:
            exclusively_owned_areas_normalized_shares(boxes)  # warm
            t0 = time.perf_counter()
            for _ in range(5):
                exclusively_owned_areas_normalized_shares(boxes)
            rows["own_areas_10_oracle_ms"] = round(
                (time.perf_counter() - t0) / 5 * 1e3, 3)
    log("own-area shares (tensor kernel) ms/frame: " + ", ".join(
        f"{n}:{rows[f'own_areas_{n}_ms']}" for n in (10, 25, 50, 100))
        + f"; f64 oracle at 10: {rows['own_areas_10_oracle_ms']}")

    # ---- VisualSORT (512-d, gallery 3): benchmarks.md:93-109 ------------
    for n in (10, 50, 100):
        row(f"visual_{n}_ms", "vis ", n,
            case_ms(place, visual_case(n, engine, dev),
                    max(10, args.reps // 2)), VISUAL_REF_MS[n])

    # ---- BatchSORT at the reference's per-call shape (one scene x N) -------
    for kind in ("iou", "maha"):
        for n in (10, 100, 500):
            key = "batch_sort" if kind == "iou" else "batch_sort_maha"
            refs = BATCH_REF_MS if kind == "iou" else BATCH_MAHA_REF_MS
            row(f"{key}_{n}_ms", f"bat{kind[0]}", n,
                case_ms(place, batch_case(kind, n, engine, dev),
                        max(10, args.reps // 2)), refs[n])

    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--objects", type=int, nargs="*",
                    default=[10, 100, 200, 300, 500, 1000])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--captures", type=int, default=3,
                    help="independent full captures; reported rows are "
                    "per-row medians")
    ap.add_argument("--engine", choices=ENGINES, default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card (default; raises without CUDA) or the "
                    "CPU's plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    caps = []
    for c in range(args.captures):
        if args.captures > 1:
            log(f"---- capture {c + 1}/{args.captures} ----")
        caps.append(measure(args))
    rows = {k: round(statistics.median([cap[k] for cap in caps]), 3)
            for k in caps[0]}
    spread = {k: [min(cap[k] for cap in caps), max(cap[k] for cap in caps)]
              for k in caps[0]} if args.captures > 1 else {}

    vs_ref = {
        f"sort_{n}_x_reference": round(
            REFERENCE_MS[n] / rows[f"sort_{n}_ms"], 4)
        for n in args.objects if n in REFERENCE_MS
    }
    # 4 decimals: a device row at 100x the reference's time still shows
    for prefix, refs in REFS.items():
        vs_ref.update({
            f"{prefix}_{n}_x_reference": round(
                ref / rows[f"{prefix}_{n}_ms"], 4)
            for n, ref in refs.items()})
    out = {
        "metric": "interactive_sort_latency_ms",
        "platform": dev.type,
        "engine": args.engine,
        "device": card,
        "reference_ms": {str(k): v for k, v in REFERENCE_MS.items()},
        "captures": args.captures,
        "rows": rows,
        "vs_reference": vs_ref,
    }
    if spread:
        out["spread_ms"] = spread
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
