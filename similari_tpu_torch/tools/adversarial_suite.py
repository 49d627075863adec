"""Adversarial accuracy suite on the port's engines (the JAX package's
`tools/adversarial_suite.py`).

Runs occlusion- and churn-heavy synthetic scenarios
(`eval/synthetic.py::generate_adversarial_sequence`,
`generate_reid_adversarial_sequence`) through the port's tracking stack
and reports MOTA / IDF1 across the engine axes that could diverge.  The
scenarios, axes, configurations (`VIS`, `OWN_AREA`), seeds, frame counts,
metrics and parity bar (0.5 pt) are the JAX tool's.

SORT scenarios (crossing, fp_burst, idle_gaps, churn, capacity), axes:
  host      - `Sort(engine="host")`: the C++ step with the exact LAP
  device_jv - the general step on the device with assignment="native"
              (the exact LAP on the host)
  auction   - the general step with the device auction
  auction_norecycle - the auction without in-step idle recycling
              (capacity x 4, so nothing overflows)

VisualSORT scenarios, per-scenario axes over the cascade:
  reid_crossing   - vhost / vdevice_jv / vauction / vbf16 / vfused
  reid_confusable - vhost / vauction / vbf16 / vfused
  reid_gaps       - vhost / vauction / vbf16 / vfused
  reid_oriented   - vhost / vauction / vbf16 (the fused kernel is
                    aligned only)
  reid_ownarea    - own-area gates: f64 polygon shares through the host
                    engine (the baseline) and through the general step,
                    against the step's device shares (`ops/ownarea.py`)
  reid_maha       - Mahalanobis positional votes in the cascade

`vhost*` is `VisualSort(engine="host")`; `vdevice_*`, `vauction*` and
`vbf16*` are the general step (`run_sequence_device_visual(engine=
"step")`); `vfused` is the fused CUDA kernel (`engine="fused"`: the
`fused_visual_kernel` after `gallery_dots` on the card, their plain
versions on the CPU), the JAX tool's `vpallas` axis.  The JAX runners'
default engine is the general step ("xla") and the port's is the fused
one, so every axis but `vfused` passes engine="step".  Where the fused
engine refuses a scenario's configuration (`check_visual_shape`), the
axis records `"refused": <the reason>` and runs nothing else.

Run: python -m similari_tpu_torch.tools.adversarial_suite
         [--device cuda|cpu] [--seeds 0 1] [--family sort|visual|all]
         [--out FILE]
The device axes run on `--device` (CUDA by default, raising without it);
the host axes on the host.  A markdown table goes to stderr, the artifact
(every row and the table) to `--out` when given, never to the JAX-era
`ADVERSARIAL_*.json`, and one JSON line to stdout: the JAX tool's plus
`device`.  An axis that raises makes
the line carry `<scenario>_<axis>_error` and the exit code 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

from ..bench_interactive import device_line, log
from ..device import resolve_device
from ..eval.metrics import clear_metrics, identity_metrics
from ..eval.mot import (run_sequence_device, run_sequence_device_visual,
                        run_sequence_interactive,
                        run_sequence_interactive_visual)
from ..eval.synthetic import (generate_adversarial_sequence,
                              generate_reid_adversarial_sequence)
from ..trackers import (PositionalMetricType, Sort, VisualSort,
                        VisualSortMetricType, VisualSortOptions)

PARITY_BAR_PT = 0.5
SORT_SCENARIOS = ("crossing", "fp_burst", "idle_gaps", "churn", "capacity")
SORT_AXES = ("host", "device_jv", "auction", "auction_norecycle")

REID_AXES = {
    "reid_crossing": ("vhost", "vdevice_jv", "vauction", "vbf16", "vfused"),
    "reid_confusable": ("vhost", "vauction", "vbf16", "vfused"),
    "reid_gaps": ("vhost", "vauction", "vbf16", "vfused"),
    "reid_oriented": ("vhost", "vauction", "vbf16"),
    "reid_ownarea": ("vhost_oa", "vdevice_oa_host", "vdevice_oa_dev"),
    "reid_maha": ("vhost_maha", "vauction_maha", "vbf16_maha"),
}

# the shared VisualSORT configuration: host options and device config built
# from the same numbers; the quality gates are nonzero so that the
# occlusion-degraded features engage them
VIS = dict(
    visual_kind="cosine", visual_threshold=0.5, minimal_track_length=3,
    iou_threshold=0.3, max_idle_epochs=5, gallery=3,
    quality_use=0.2, quality_collect=0.6,
)
OWN_AREA = dict(own_area_use=0.4, own_area_collect=0.6)

SORT_FRAMES = 240  # the crossing's columns bounce and re-cross


class Refused(Exception):
    """The fused engine refused the configuration; the axis records why."""


def run_axis(axis, dets, capacity, device=None):
    """One SORT axis's predictions of a sequence."""
    if axis == "host":
        tracker = Sort(shards=1, bbox_history=1, max_idle_epochs=5,
                       method=PositionalMetricType.iou(0.3), engine="host",
                       initial_capacity=capacity, device="cpu")
        return run_sequence_interactive(tracker, dets)
    kw = dict(method="iou", iou_threshold=0.3, max_idle_epochs=5,
              capacity=capacity, device=device, engine="step")
    if axis == "device_jv":
        out, _ = run_sequence_device(dets, assignment="native", **kw)
    elif axis == "auction":
        out, _ = run_sequence_device(dets, assignment="auction", **kw)
    elif axis == "auction_norecycle":
        out, _ = run_sequence_device(dets, assignment="auction",
                                     recycle_idle=False,
                                     **{**kw, "capacity": 4 * capacity})
    else:
        raise ValueError(axis)
    return out


def _host_visual_tracker(maha=False, own_area=False, capacity=256):
    opts = VisualSortOptions()
    opts.visual_metric(VisualSortMetricType.cosine(VIS["visual_threshold"]))
    opts.positional_metric(
        PositionalMetricType.maha() if maha
        else PositionalMetricType.iou(VIS["iou_threshold"]))
    opts.visual_minimal_track_length(VIS["minimal_track_length"])
    opts.visual_max_observations(VIS["gallery"])
    opts.max_idle_epochs(VIS["max_idle_epochs"])
    opts.visual_minimal_quality_use(VIS["quality_use"])
    opts.visual_minimal_quality_collect(VIS["quality_collect"])
    if own_area:
        opts.visual_minimal_own_area_percentage_use(OWN_AREA["own_area_use"])
        opts.visual_minimal_own_area_percentage_collect(
            OWN_AREA["own_area_collect"])
        opts.own_area_backend("host")  # the exact f64 polygon oracle
    return VisualSort(1, opts, initial_capacity=capacity, engine="host",
                      assignment_backend="native", device="cpu")


# axis -> the keyword arguments of `run_sequence_device_visual`
DEVICE_VISUAL_AXES = {
    "vdevice_jv": dict(assignment="native", feature_precision="f32"),
    "vauction": dict(assignment="auction", feature_precision="f32"),
    "vbf16": dict(assignment="auction", feature_precision="bf16"),
    "vfused": dict(engine="fused", assignment="auction",
                   feature_precision="f32"),
    "vdevice_oa_host": dict(assignment="native", feature_precision="f32",
                            own_area_backend="host", **OWN_AREA),
    "vdevice_oa_dev": dict(assignment="native", feature_precision="f32",
                           own_area_backend="device", **OWN_AREA),
    "vauction_maha": dict(assignment="auction", feature_precision="f32",
                          positional_kind="maha"),
    "vbf16_maha": dict(assignment="auction", feature_precision="bf16",
                       positional_kind="maha"),
}


def run_visual_axis(axis, dets, feats, quals, capacity, oriented=False,
                    device=None):
    """One VisualSORT axis's predictions of a sequence; `Refused` where the
    fused engine refuses the configuration."""
    if axis.startswith("vhost"):
        tracker = _host_visual_tracker(
            maha=axis.endswith("_maha"), own_area=axis.endswith("_oa"),
            capacity=capacity)
        return run_sequence_interactive_visual(tracker, dets, feats, quals)
    if axis not in DEVICE_VISUAL_AXES:
        raise ValueError(axis)
    kw = dict(
        visual_kind=VIS["visual_kind"],
        visual_threshold=VIS["visual_threshold"],
        minimal_track_length=VIS["minimal_track_length"],
        iou_threshold=VIS["iou_threshold"],
        max_idle_epochs=VIS["max_idle_epochs"],
        gallery=VIS["gallery"],
        capacity=capacity,
        qualities=quals,
        visual_minimal_quality_use=VIS["quality_use"],
        visual_minimal_quality_collect=VIS["quality_collect"],
        oriented=oriented,
        device=device,
        engine="step",
    )
    kw.update(DEVICE_VISUAL_AXES[axis])
    try:
        out, _ = run_sequence_device_visual(dets, feats, **kw)
    except ValueError as e:
        if kw["engine"] == "fused":
            raise Refused(str(e)) from e
        raise
    return out


class SortRunner:
    def __init__(self, scenario, device):
        self.scenario = scenario
        self.capacity = 1024 if scenario == "capacity" else 256
        self.device = device

    def make(self, seed, n_frames=None):
        return generate_adversarial_sequence(
            self.scenario, seed, n_frames=n_frames or SORT_FRAMES)

    def run(self, axis, streams):
        _, dets = streams
        return run_axis(axis, dets, self.capacity, self.device)


class VisualRunner:
    def __init__(self, scenario, device):
        self.scenario = scenario
        self.capacity = 256
        self.stream_scenario = {"reid_ownarea": "reid_crossing",
                                "reid_maha": "reid_crossing"}.get(
                                    scenario, scenario)
        self.oriented = scenario == "reid_oriented"
        self.device = device

    def make(self, seed, n_frames=None):
        kw = {} if n_frames is None else {"n_frames": n_frames}
        return generate_reid_adversarial_sequence(self.stream_scenario, seed,
                                                  **kw)

    def run(self, axis, streams):
        _, dets, feats, quals = streams
        return run_visual_axis(axis, dets, feats, quals, self.capacity,
                               self.oriented, self.device)


def score(gt, pred):
    """(MOTA, IDF1) in points."""
    return (clear_metrics(gt, pred)["MOTA"] * 100,
            identity_metrics(gt, pred)["IDF1"] * 100)


def score_block(scenario, axes, runner, seeds, results, lines):
    """Every axis of one scenario over the seeds; rows into `results`, the
    table's lines into `lines`; returns (worst |delta|, nonzero rows)."""
    agg = {a: {"MOTA": [], "IDF1": []} for a in axes}
    refused, failed = {}, {}
    for seed in seeds:
        streams = runner.make(seed)
        for axis in axes:
            if axis in refused or axis in failed:
                continue
            try:
                pred = runner.run(axis, streams)
            except Refused as e:
                refused[axis] = str(e)
                log(f"  seed {seed} {axis:18s} refused: {e}")
                continue
            except Exception as e:  # recorded; the suite goes on, exits 1
                traceback.print_exc(file=sys.stderr)
                failed[axis] = repr(e)[:200]
                continue
            mota, idf1 = score(streams[0], pred)
            agg[axis]["MOTA"].append(mota)
            agg[axis]["IDF1"].append(idf1)
            log(f"  seed {seed} {axis:18s} MOTA {mota:6.2f}  IDF1 "
                f"{idf1:6.2f}")
    worst, nonzero = 0.0, 0
    if axes[0] in refused or axes[0] in failed:
        base = None
    else:
        base = {k: sum(v) / len(v) for k, v in agg[axes[0]].items()}
    for axis in axes:
        key = f"{scenario}_{axis}"
        if axis in refused:
            results[key] = {"refused": refused[axis]}
            lines.append(f"| {scenario} | {axis} | refused | | | |")
            continue
        if axis in failed:
            results[key + "_error"] = failed[axis]
            continue
        mota = sum(agg[axis]["MOTA"]) / len(agg[axis]["MOTA"])
        idf1 = sum(agg[axis]["IDF1"]) / len(agg[axis]["IDF1"])
        dm = mota - base["MOTA"] if base else float("nan")
        di = idf1 - base["IDF1"] if base else float("nan")
        if axis != axes[0] and base:
            worst = max(worst, abs(dm), abs(di))
            if abs(dm) > 1e-9 or abs(di) > 1e-9:
                nonzero += 1
        results[key] = {"MOTA": round(mota, 2), "IDF1": round(idf1, 2),
                        "dMOTA": round(dm, 2), "dIDF1": round(di, 2)}
        lines.append(f"| {scenario} | {axis} | {mota:.2f} | {idf1:.2f} | "
                     f"{dm:+.2f} | {di:+.2f} |")
        log(f"{scenario:14s} {axis:18s} MOTA {mota:6.2f}  IDF1 "
            f"{idf1:6.2f}  d=({dm:+.2f}, {di:+.2f})")
    return worst, nonzero


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--out", default=None,
                    help="write the artifact (every row, the table) here")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--family", choices=["sort", "visual", "all"],
                    default="all")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}")

    results = {}
    lines = [
        "| Scenario | axis | MOTA | IDF1 | ΔMOTA vs baseline (pt) | ΔIDF1 (pt) |",
        "|---|---|---|---|---|---|",
    ]
    blocks = []
    if args.family in ("sort", "all"):
        blocks += [(s, SORT_AXES, SortRunner(s, dev))
                   for s in SORT_SCENARIOS]
    if args.family in ("visual", "all"):
        blocks += [(s, axes, VisualRunner(s, dev))
                   for s, axes in REID_AXES.items()]
    worst, nonzero = 0.0, 0
    for scenario, axes, runner in blocks:
        w, nz = score_block(scenario, axes, runner, args.seeds, results,
                            lines)
        worst, nonzero = max(worst, w), nonzero + nz

    errors = [k for k in results if k.endswith("_error")]
    ok = worst <= PARITY_BAR_PT
    log("\n".join(lines))
    log(f"worst |delta| across non-baseline axes: {worst:.2f} pt "
        f"({'PASS' if ok else 'FAIL'} vs the {PARITY_BAR_PT} pt parity "
        f"bar); {nonzero} axis rows with a nonzero delta; errors {errors}")
    blob = {
        "metric": "adversarial_accuracy_deltas",
        "parity_bar_pt": PARITY_BAR_PT,
        "worst_abs_delta_pt": round(worst, 3),
        "nonzero_delta_rows": nonzero,
        "seeds": args.seeds,
        "device": card,
        "rows": results,
        "table_md": "\n".join(lines),
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(blob, indent=1))
    print(json.dumps({"metric": "adversarial_worst_delta_pt",
                      "value": round(worst, 3), "pass": ok,
                      "nonzero_delta_rows": nonzero, "device": card,
                      **{k: results[k] for k in errors}}))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
