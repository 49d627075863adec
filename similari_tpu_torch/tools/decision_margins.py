"""Decision margins of the adversarial suite's cascade (the JAX package's
`tools/decision_margins.py`), with the own-area axis on the port's kernel.

The adversarial suite's engine axes (the exact LAP against the auction,
f32 against bf16 galleries, host f64 against device own-area shares, the
fused kernel) come out with deltas of exactly 0.000 pt MOTA / IDF1 on the
port too (`tools/adversarial_suite.py`), on streams hard enough for real
id switches.  This tool says why: it replays the adversarial ReID streams
through the repo's NumPy oracle (`tests/reference_visual.py`, loaded by
path from `tests/` as the JAX tool loads it; one oracle for both
packages) and records, per frame, the margin of every decision the
cascade makes beside each engine axis's perturbation:

  claim margin   - for each track claimed in the BestFit stage, the gap
                   between the winning candidate's summed weight and the
                   runner-up's;
  row margin     - for each positionally assigned row, the gap between the
                   chosen weight and the row's best alternative (the
                   new-track threshold included);
  exact ties     - competing weight pairs that are bit-equal (the only
                   place exact solvers that break ties differently can
                   diverge);
  bf16 delta     - max |w_f32 - w_bf16| over the frame's feature-distance
                   records, the galleries and queries rounded to bf16 by
                   `ops/gallery_dots.py::round_bf16`, the rounding of the
                   port's bf16 gallery (the oracle's arithmetic stays
                   NumPy f32, as in the JAX tool);
  gate margin    - min distance of a feature distance or quality to its
                   gate threshold;
  own-area delta - max |share_host_f64 - share_device| between the f64
                   polygon oracle (`utils/clipping.py::
                   exclusively_owned_areas_normalized_shares`) and the
                   port's `ops/own_area_shares` on `--device`, every 10th
                   frame of reid_crossing.

The scenarios, oracle configuration, streams (`eval/synthetic.py`,
`eval/mot.py::ltwh_to_vec5`) and every derived number are the JAX
tool's; only the own-area delta depends on the device.

Run: python -m similari_tpu_torch.tools.decision_margins
         [--device cuda|cpu] [--seeds 0 1] [--out FILE]
The own-area shares run on `--device` (CUDA by default, raising without
it).  A markdown table goes to stderr, the artifact (rows, table, note,
`device`) to `--out` when given and nowhere else (never the JAX-era
`MARGINS_r05.json`), and one JSON line to stdout: the JAX tool's plus
`device`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..bench_interactive import device_line, log
from ..device import resolve_device
from ..eval.mot import ltwh_to_vec5
from ..eval.synthetic import generate_reid_adversarial_sequence
from ..ops.gallery_dots import round_bf16
from ..ops.ownarea import own_area_shares
from ..utils.bbox import Universal2DBox
from ..utils.clipping import exclusively_owned_areas_normalized_shares

TESTS = Path(__file__).resolve().parents[2] / "tests"
SCENARIOS = ("reid_crossing", "reid_confusable", "reid_gaps")
OWN_AREA_GATES = (0.4, 0.6)
OWN_AREA_EVERY = 10  # frames between own-area probes
NOTE = (
    "margins measured on the NumPy oracle replaying the adversarial ReID "
    "streams.  bf16 does flip VOTES (records sit within its delta of the "
    "use-gate) but the BestFit weight design makes gate-marginal votes "
    "contribute ~zero weight, so the CLAIM margins - the decisions that set "
    "track ids - stay an order of magnitude above the perturbation; "
    "positional matrices are bit-identical across axes and exact-tie-free, "
    "so the exact solvers cannot diverge.  The suite's 0.00 deltas are "
    "structural, not untested parity.")


def oracle():
    """The repo's NumPy oracle modules (`tests/reference_visual.py`,
    `tests/reference_sort.py`), imported from `tests/` on the path."""
    if str(TESTS) not in sys.path:
        sys.path.insert(0, str(TESTS))
    import reference_sort
    import reference_visual

    return reference_visual, reference_sort


def bf16(x) -> np.ndarray:
    """f32 values rounded to bfloat16 and back, as a NumPy f32 array."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return round_bf16(t).numpy()


class MarginProbe:
    """Wraps RefVisualSort.predict with margin instrumentation."""

    def __init__(self, tracker, own_area_gates=(), device=None):
        self.t = tracker
        self.claim_margins = []
        self.row_margins = []
        self.exact_ties = 0
        self.competing_pairs = 0
        self.bf16_deltas = []
        self.gate_margins = []
        self.ownarea_deltas = []
        self.ownarea_gate_margins = []
        self.own_area_gates = own_area_gates
        self.device = device

    def predict(self, boxes, confs, feats, qualities):
        t = self.t
        tr = [x for x in t.tracks
              if x.last_epoch + t.max_idle >= t.epoch + 1]
        self._probe_features(tr, boxes, feats, qualities)
        self._probe_positional(tr, boxes, confs)
        return t.predict(boxes, confs, feats, qualities)

    # -- feature stage: weights in f32 and bf16, claim margins, gates ------
    def _probe_features(self, tr, boxes, feats, qualities):
        t = self.t
        rec32, rec16 = {}, {}
        # each gallery lane rounded once a frame (the JAX tool rounds it
        # per pair: the same values)
        g16 = {j: [bf16(g) for g, _ in track.gallery]
               for j, track in enumerate(tr) if track.collected >= t.mtl}
        for i in range(len(boxes)):
            if feats[i] is None or not t._use_ok(boxes[i], qualities[i]):
                continue
            qv = np.asarray(feats[i], np.float32)
            qv16 = bf16(qv)
            for j, track in enumerate(tr):
                if track.collected < t.mtl:
                    continue
                for (gfeat, _gq), gv16 in zip(track.gallery, g16[j]):
                    dd = t._vdist(qv, gfeat)
                    if t.vkind == "euclidean":
                        dd16 = float(np.linalg.norm(qv16 - gv16))
                        ok, ok16 = dd <= t.vthr, dd16 <= t.vthr
                        w, w16 = dd, dd16
                    else:
                        num = float(qv16 @ gv16)
                        den = float(np.sqrt((qv16 @ qv16) * (gv16 @ gv16)))
                        dd16 = num / den
                        ok, ok16 = dd >= t.vthr, dd16 >= t.vthr
                        w, w16 = 1.0 - dd, 1.0 - dd16
                    self.gate_margins.append(abs(dd - t.vthr))
                    if ok:
                        rec32.setdefault((i, j), []).append(w)
                    if ok16:
                        rec16.setdefault((i, j), []).append(w16)
                    if ok and ok16:
                        self.bf16_deltas.append(abs(w - w16))
            self.gate_margins.append(abs(qualities[i] - t.q_use))
            self.gate_margins.append(abs(qualities[i] - t.q_collect))
        # summed BestFit weights (f32) -> claim margins
        if not rec32:
            return
        max_dist = max(w for ws in rec32.values() for w in ws)
        elts = {(i, j): sum(max_dist - w for w in ws)
                for (i, j), ws in rec32.items() if len(ws) >= t.min_votes}
        by_track, by_cand = {}, {}
        for (i, j), w in elts.items():
            by_track.setdefault(j, []).append(w)
            by_cand.setdefault(i, []).append(w)
        for groups in (by_track, by_cand):
            for ws in groups.values():
                if len(ws) < 2:
                    continue
                ws = sorted(ws, reverse=True)
                gap = ws[0] - ws[1]
                self.competing_pairs += 1
                if gap == 0.0:
                    self.exact_ties += 1
                else:
                    self.claim_margins.append(gap)

    # -- positional stage: row margins and exact-tie density --------------
    def _probe_positional(self, tr, boxes, confs):
        from scipy.optimize import linear_sum_assignment

        _, ref_sort = oracle()
        t = self.t
        d = len(boxes)
        n = len(tr)
        W = np.zeros((d, d + n), np.float32)
        for i in range(d):
            W[i, i] = t.thr
        for i in range(d):
            conf = max(confs[i], t.pmc)
            for j, track in enumerate(tr):
                if ref_sort.too_far(boxes[i], track.pred):
                    continue
                if t.pkind == "iou":
                    iou = ref_sort.rect_iou(boxes[i], track.pred)
                    if iou <= 0.0:
                        continue
                    m = iou * conf
                    W[i, d + j] = m if m >= t.thr else 0.0
        rr, cc = linear_sum_assignment(W, maximize=True)
        for r, c in zip(rr.tolist(), cc.tolist()):
            row = W[r].copy()
            chosen = row[c]
            row[c] = -np.inf
            alt = float(row.max())
            if chosen <= 0.0 and alt <= 0.0:
                continue
            gap = float(chosen - alt)
            self.competing_pairs += 1
            if gap == 0.0:
                self.exact_ties += 1
            else:
                self.row_margins.append(abs(gap))

    # -- own-area axis: host f64 oracle against the device shares ----------
    def probe_own_area(self, boxes_vec5, confs):
        if not self.own_area_gates:
            return
        ub = [Universal2DBox.from_vec5(b, float(c))
              for b, c in zip(boxes_vec5, confs)]
        host = np.asarray(exclusively_owned_areas_normalized_shares(ub),
                          np.float64)
        dev = own_area_shares(
            torch.as_tensor(np.asarray(boxes_vec5, np.float32),
                            device=self.device),
            torch.ones((len(ub),), dtype=torch.bool, device=self.device))
        dev = dev.cpu().numpy().astype(np.float64)
        self.ownarea_deltas.append(float(np.abs(host - dev).max()))
        for g in self.own_area_gates:
            self.ownarea_gate_margins.append(float(np.abs(host - g).min()))


def run_scenario(scenario, seeds, own_area=False, device=None,
                 n_frames=None):
    """Every probe's records over the seeds' streams (all their frames, or
    the first `n_frames`)."""
    ref_visual, _ = oracle()
    stats = dict(claim=[], row=[], bf16=[], gate=[], oad=[], oag=[],
                 ties=0, pairs=0)
    kw = {} if n_frames is None else {"n_frames": n_frames}
    for seed in seeds:
        _, dets, feats, quals = generate_reid_adversarial_sequence(
            scenario, seed, **kw)
        tracker = ref_visual.RefVisualSort(
            iou_threshold=0.3, visual_kind="cosine", visual_threshold=0.5,
            minimal_track_length=3, quality_use=0.2, quality_collect=0.6,
            max_observations=3, min_votes=1, max_idle_epochs=5)
        probe = MarginProbe(tracker, OWN_AREA_GATES if own_area else (),
                            device)
        for f in sorted(dets):
            rows = np.asarray(dets[f], np.float32)
            boxes = ltwh_to_vec5(rows)
            confs = np.clip(rows[:, 4], 0, 1)
            fr = [np.asarray(x, np.float32) if x is not None else None
                  for x in feats[f]]
            probe.predict(boxes, confs, fr, quals[f])
            if own_area and f % OWN_AREA_EVERY == 0:
                probe.probe_own_area(boxes, confs)
        stats["claim"] += probe.claim_margins
        stats["row"] += probe.row_margins
        stats["bf16"] += probe.bf16_deltas
        stats["gate"] += probe.gate_margins
        stats["oad"] += probe.ownarea_deltas
        stats["oag"] += probe.ownarea_gate_margins
        stats["ties"] += probe.exact_ties
        stats["pairs"] += probe.competing_pairs
    return stats


def summarize(scenario, st):
    """(the artifact's row, the table line, the log line) of one
    scenario's records."""
    mc = min(st["claim"]) if st["claim"] else float("inf")
    mr = min(st["row"]) if st["row"] else float("inf")
    mb = max(st["bf16"]) if st["bf16"] else 0.0
    mg = min(st["gate"]) if st["gate"] else float("inf")
    # the bf16 axis perturbs only the feature weights, so the decision it
    # could flip is the BestFit claim: ratio = claim margin / delta w
    ratio = (mc / mb) if mb > 0 else float("inf")
    flippable = sum(1 for g in st["gate"] if g <= mb)
    row = {
        "min_claim_margin": mc, "min_row_margin": mr,
        "exact_ties": st["ties"], "competing_pairs": st["pairs"],
        "max_bf16_weight_delta": mb, "min_gate_margin": mg,
        "bf16_flippable_votes": flippable,
        "claim_margin_over_bf16": ratio,
        "n_claim": len(st["claim"]), "n_row": len(st["row"]),
    }
    if st["oad"]:
        row["max_ownarea_host_dev_delta"] = max(st["oad"])
        row["min_ownarea_gate_margin"] = min(st["oag"])
    line = (f"| {scenario} | {mc:.2e} | {mb:.2e} | {ratio:,.0f}x | "
            f"{flippable} | {mr:.2e} | {st['ties']} / {st['pairs']} |")
    msg = (f"{scenario}: claim>={mc:.3e} bf16<={mb:.3e} (x{ratio:,.0f}) "
           f"flippable-votes={flippable} row>={mr:.3e} ties={st['ties']}"
           f"/{st['pairs']}"
           + (f" ownareaΔ<={max(st['oad']):.2e}"
              f" oa-gate>={min(st['oag']):.2e}" if st["oad"] else ""))
    return row, line, msg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--out", default=None,
                    help="write the artifact (rows, table, note) here")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}")

    rows = {}
    lines = [
        "| Scenario | min claim margin | max bf16 Δw | claim ÷ bf16 | "
        "bf16-flippable votes | min row margin | exact ties / competing "
        "pairs |",
        "|---|---|---|---|---|---|---|",
    ]
    for scenario in SCENARIOS:
        st = run_scenario(scenario, args.seeds,
                          own_area=scenario == "reid_crossing", device=dev)
        rows[scenario], line, msg = summarize(scenario, st)
        lines.append(line)
        log(msg)
    log("\n".join(lines))
    blob = {
        "metric": "adversarial_decision_margins",
        "seeds": args.seeds,
        "device": card,
        "rows": rows,
        "table_md": "\n".join(lines),
        "note": NOTE,
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(blob, indent=1))
    print(json.dumps({
        "metric": "min_claim_margin_over_bf16_delta",
        "value": min(r["claim_margin_over_bf16"] for r in rows.values()),
        "device": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
