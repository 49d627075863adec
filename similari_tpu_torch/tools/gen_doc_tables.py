"""Regenerate the port's tables in README.md from its own artifacts (the
JAX package's `tools/gen_doc_tables.py`).

The JAX tool rewrites README's, PARITY.md's and ARCHITECTURE.md's
generated blocks from the newest `BENCH_r*.json` and friends, TPU
captures.  This tool reads only the artifacts it is given, each made by
one of the port's entry points on a card:

  --bench        the stdout line of `python -m similari_tpu_torch.bench`
  --interactive  the stdout line of `python -m
                 similari_tpu_torch.bench_interactive` (host engine: the
                 reference's per-call rows)
  --adversarial  the `--out` artifact of `tools.adversarial_suite`
  --margins      the `--out` artifact of `tools.decision_margins`

and rewrites only the port's blocks, delimited by
`<!-- BEGIN GENERATED: port-<name> -->` / `<!-- END GENERATED:
port-<name> -->` in README's port section, one per JAX block it has data
for: `port-headline` (the reference's CPU numbers against the port's,
bench + interactive), `port-full-matrix` (bench + interactive),
`port-adversarial`, `port-margins`, `port-interactive-ranges`
(interactive).  A block whose artifacts are not given is left as it is.
Every table names the card and power limit of each artifact it quotes.
An artifact whose `device` is not a card's `nvidia-smi` line (name,
power limit in W) is refused: exit code 1 and nothing written.  The
JAX-era blocks and files are never read or touched.

Run: python -m similari_tpu_torch.tools.gen_doc_tables [--device cuda|cpu]
         [--bench FILE] [--interactive FILE] [--adversarial FILE]
         [--margins FILE] [--readme README.md]
Like every entry point of the port it runs on the card unless given
`--device cpu` (it launches nothing).  One JSON line on stdout: the
blocks regenerated, the README written and `device`.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from ..bench_interactive import device_line, log
from ..device import resolve_device

ROOT = Path(__file__).resolve().parents[2]

# reference rows: name -> (label, reference FPS, unit), the JAX tool's
REF = {
    "sort_iou_10": ("SORT IoU, 10 objects", 9900, "FPS"),
    "sort_iou_100": ("SORT IoU, 100 objects", 561, "FPS"),
    "sort_iou_500": ("SORT IoU, 500 objects", 53, "FPS"),
    "sort_iou_oriented_100": ("SORT IoU oriented, 100 objects", 624, "FPS"),
    "sort_iou_oriented_500": ("SORT IoU oriented, 500 objects", 52, "FPS"),
    "sort_maha_100": ("SORT Maha, 100 objects", 588, "FPS"),
    "sort_maha_oriented_100": ("SORT Maha oriented, 100 objects", 636, "FPS"),
    "visual_sort_10x512": ("VisualSORT 10 obj x 512-d", 2230, "FPS"),
    "visual_sort_50x512": ("VisualSORT 50 obj x 512-d", 444, "FPS"),
    "visual_sort_100x128": ("VisualSORT 100 obj x 128-d", 262, "FPS"),
    "visual_sort_100x256": ("VisualSORT 100 obj x 256-d", 211, "FPS"),
    "visual_sort_100x512": ("VisualSORT 100 obj x 512-d", 173, "FPS"),
    "visual_sort_100x1024": ("VisualSORT 100 obj x 1024-d", 133, "FPS"),
    "visual_sort_100x2048": ("VisualSORT 100 obj x 2048-d", 94, "FPS"),
    "nms_10": ("NMS, 10 boxes", 632000, "frames/s"),
    "nms_100": ("NMS, 100 boxes", 6711, "frames/s"),
    "nms_500": ("NMS, 500 boxes", 250, "frames/s"),
    "nms_1000": ("NMS, 1000 boxes", 72, "frames/s"),
    "nms_oriented_10": ("NMS oriented, 10 boxes", 461000, "frames/s"),
    "nms_oriented_100": ("NMS oriented, 100 boxes", 7100, "frames/s"),
    "nms_oriented_300": ("NMS oriented, 300 boxes", 570, "frames/s"),
    "nms_oriented_500": ("NMS oriented, 500 boxes", 218, "frames/s"),
    "nms_oriented_1000": ("NMS oriented, 1000 boxes", 54, "frames/s"),
}

HEADLINE = [
    "sort_iou_100", "sort_iou_oriented_100", "sort_iou_500",
    "sort_iou_oriented_500",
    "visual_sort_100x512_pallas", "visual_sort_100x512",
    "batch_sort_1024x100", "batch_visual_256x100x512",
]
SPECIAL = {
    "visual_sort_100x512_pallas": (
        "VisualSORT 100 obj x 512-d (fused CUDA kernel)", 173, "FPS"),
    "batch_sort_1024x100": (
        "Batch 1024 scenes x 100 obj (SORT IoU)", 618, "scene-frames/s"),
    "batch_visual_256x100x512": (
        "Batch VisualSORT 256 x 100 x 512-d (bf16)", 173, "scene-frames/s"),
}
# the reference's per-call ms of the host rows (the JAX tool's numbers)
FEATURE_REFS = {10: 0.101465, 100: 4.020673, 500: 61.716729}
ORIENTED_REFS = {10: 0.108414, 100: 1.601062, 500: 18.945655}
VISUAL_REFS = {10: 0.447903, 50: 2.249694, 100: 5.775469}
BATCH_REFS = {10: 0.106876, 100: 1.616542, 500: 20.454230}
BATCH_MAHA_REFS = {10: 0.114592, 100: 1.533445, 500: 18.270742}
UNPUBLISHED = "bench exists, no published number"
CARD = re.compile(r"[^,]+, [0-9]+(\.[0-9]+)? W")


class Refused(Exception):
    """An artifact that was not made on a card."""


def fmt(v):
    if v >= 1e6:
        return f"{v / 1e6:.2f}M"
    if v >= 1e3:
        return f"{v / 1e3:.1f}k"
    return f"{v:.0f}"


def load(path):
    """An artifact: a JSON file, or the last line of an entry point's
    stdout.  Refused unless its `device` is a card's name and power
    limit."""
    text = Path(path).read_text()
    try:
        blob = json.loads(text)
    except json.JSONDecodeError:
        blob = json.loads(text.strip().splitlines()[-1])
    device = blob.get("device")
    if not isinstance(device, str) or not CARD.fullmatch(device):
        raise Refused(f"{path}: device {device!r} is not a card's "
                      "`nvidia-smi` name and power limit")
    return blob


def source(path, blob):
    engine = f" ({blob['engine']} engine)" if "engine" in blob else ""
    return f"`{path}`{engine} on {blob['device']}"


def headline(bench, inter, src):
    extra = bench.get("extra", bench)
    lines = ["| Benchmark | Reference (CPU) | similari_tpu_torch (one card) "
             "| Speedup |", "|---|---|---|---|"]
    for key in HEADLINE:
        label, ref, unit = SPECIAL.get(key) or REF[key]
        v = extra.get(f"{key}_fps")
        if v is None:
            continue
        lines.append(
            f"| {label} | {ref:,} FPS | {fmt(v)} {unit} | {v / ref:.0f}x |")
    it = inter["rows"] if inter else {}
    if "sort_100_ms" in it and "sort_1000_ms" in it:
        lines.append(
            f"| Interactive per-call `Sort.predict`, 100 / 1000 objects | "
            f"1.66 / 53.1 ms | "
            f"{it['sort_100_ms']} / {it['sort_1000_ms']} ms | "
            f"{1.66 / it['sort_100_ms']:.0f}x / "
            f"{53.098 / it['sort_1000_ms']:.0f}x |")
    return "\n".join(lines) + f"\n\n(numbers from {src})\n"


def _host_rows(inter):
    """The full matrix's per-call rows of the interactive artifact."""
    it, lines = inter["rows"], []
    for n in (10, 100, 200, 300, 500, 1000):
        k = f"sort_{n}_ms"
        if k in it:
            ref_ms = inter["reference_ms"][str(n)]
            lines.append(
                f"| Python per-call `Sort.predict`, {n} objects | {ref_ms} "
                f"ms | {it[k]} ms | {ref_ms / it[k]:.1f}x |")
    for prefix, label, refs in (
            ("feature", "Feature engine (256-d, gallery 3), {n} objects",
             FEATURE_REFS),
            ("sort_oriented", "Oriented SORT per-call (host f32 clip), {n} "
             "objects", ORIENTED_REFS),
            ("visual", "VisualSORT per-call (512-d), {n} objects",
             VISUAL_REFS),
            ("batch_sort", "BatchSORT per-call (1 scene x {n}, IoU)",
             BATCH_REFS),
            ("batch_sort_maha", "BatchSORT per-call (1 scene x {n}, Maha)",
             BATCH_MAHA_REFS)):
        for n, ref in refs.items():
            k = f"{prefix}_{n}_ms"
            if k in it:
                lines.append(f"| {label.format(n=n)} | {ref:.3f} ms | "
                             f"{it[k]} ms | {ref / it[k]:.1f}x |")
    for vec_len, count in ((128, 1000), (128, 10000), (512, 1000),
                           (512, 10000)):
        k = f"store_search_{vec_len}_{count}_ms"
        ka = f"store_search_{vec_len}_{count}_arrays_ms"
        if k in it:
            arr = f" / {it[ka]} ms arrays API" if ka in it else ""
            lines.append(
                f"| Store search {vec_len}-d x {count} tracks "
                f"(benches/simple_search.rs) | {UNPUBLISHED} | {it[k]} ms "
                f"records{arr} | — |")
    if "track_search_256_30_100_ms" in it:
        arr = (f" / {it['track_search_256_30_100_arrays_ms']} ms arrays API"
               if "track_search_256_30_100_arrays_ms" in it else "")
        lines.append(
            f"| Track search 256-d x 30 obs x 100 tracks "
            f"(benches/track_search.rs) | {UNPUBLISHED} | "
            f"{it['track_search_256_30_100_ms']} ms records{arr} | — |")
    for kind, bench_rs, label in (("bbox", "kalman_bbox", "Kalman bbox"),
                                  ("point", "kalman_2d_point",
                                   "Kalman 2D point")):
        k = f"kalman_{kind}_100k_ms"
        if k in it:
            lines.append(
                f"| {label} 100k predict/update (benches/{bench_rs}.rs) | "
                f"{UNPUBLISHED} | {it[k]} ms per-call API / "
                f"{it.get(f'kalman_{kind}_100k_bulk_ms', '—')} ms bulk "
                f"filter_sequence | — |")
    if "own_areas_100_ms" in it:
        oa = ", ".join(f"{n}: {it[f'own_areas_{n}_ms']} ms"
                       for n in (10, 25, 50, 100)
                       if f"own_areas_{n}_ms" in it)
        lines.append(
            f"| Own-area shares (benches/bbox_own_areas.rs) | {UNPUBLISHED} "
            f"| {oa} per frame | — |")
    return lines


def full_matrix(bench, inter, src):
    extra = bench.get("extra", bench) if bench else {}
    lines = ["| Reference benchmark row | reference | similari_tpu_torch "
             "| x |", "|---|---|---|---|"]
    if bench:
        for key, (label, ref, unit) in REF.items():
            v = extra.get(f"{key}_fps")
            cell = (f"{fmt(v)} {unit}" if v is not None
                    else "N/A (not captured)")
            mult = f"{v / ref:.1f}x" if v is not None else "—"
            lines.append(f"| {label} | {ref:,} | {cell} | {mult} |")
    if inter:
        lines += _host_rows(inter)
    return "\n".join(lines) + f"\n\n(numbers from {src})\n"


def adversarial(blob, src):
    return (blob["table_md"]
            + f"\n\nWorst |delta| across non-baseline axes: "
            f"**{blob['worst_abs_delta_pt']} pt** (parity bar "
            f"{blob['parity_bar_pt']} pt; seeds {blob['seeds']}; from {src}, "
            f"`tools.adversarial_suite`)\n")


def margins(blob, src):
    return (blob["table_md"] + f"\n\n{blob['note']} (from {src}, "
            f"`tools.decision_margins`)\n")


def interactive_ranges(inter, src):
    vr = inter.get("vs_reference", {})

    def fam_range(pat):
        vals = [v for k, v in vr.items() if re.match(pat, k)]
        if not vals:
            return "×?"

        def one(v):
            return (f"{v:.1f}".rstrip("0").rstrip(".") if v < 10
                    else f"{v:.0f}")

        return f"×{one(min(vals))}–×{one(max(vals))}"

    return (f"SORT {fam_range(r'sort_[0-9]+_x_reference')}, "
            f"oriented SORT {fam_range(r'sort_oriented_')}, "
            f"VisualSORT {fam_range(r'visual_')}, "
            f"BatchSORT {fam_range(r'batch_sort_')}, "
            f"feature engine {fam_range(r'feature_')} (from {src})\n")


def replace_block(text, name, body):
    """`text` with the port block `name` rewritten, or None without it."""
    if not name.startswith("port-"):
        raise ValueError(f"{name}: only the port's blocks are rewritten")
    pat = re.compile(rf"(<!-- BEGIN GENERATED: {name} -->\n).*?"
                     rf"(<!-- END GENERATED: {name} -->)", re.S)
    if not pat.search(text):
        return None
    return pat.sub(lambda m: m.group(1) + body + m.group(2), text)


def blocks(args):
    """{block name: body} of every block the given artifacts feed."""
    arts = {k: (p, load(p)) for k, p in (
        ("bench", args.bench), ("interactive", args.interactive),
        ("adversarial", args.adversarial), ("margins", args.margins)) if p}
    bench = arts.get("bench", (None, None))[1]
    inter = arts.get("interactive", (None, None))[1]
    src = {k: source(p, b) for k, (p, b) in arts.items()}
    out = {}
    if bench:
        out["port-headline"] = headline(bench, inter, " + ".join(
            src[k] for k in ("bench", "interactive") if k in src))
    if bench or inter:
        out["port-full-matrix"] = full_matrix(bench, inter, " + ".join(
            src[k] for k in ("bench", "interactive") if k in src))
    if "adversarial" in arts:
        out["port-adversarial"] = adversarial(arts["adversarial"][1],
                                              src["adversarial"])
    if "margins" in arts:
        out["port-margins"] = margins(arts["margins"][1], src["margins"])
    if inter:
        out["port-interactive-ranges"] = interactive_ranges(
            inter, src["interactive"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--bench")
    ap.add_argument("--interactive")
    ap.add_argument("--adversarial")
    ap.add_argument("--margins")
    ap.add_argument("--readme", default=str(ROOT / "README.md"))
    args = ap.parse_args(argv)
    card = device_line(resolve_device(args.device))
    try:
        new = blocks(args)
    except Refused as e:
        log(f"refused: {e}")
        return 1
    path = Path(args.readme)
    text = path.read_text()
    done = []
    for name, body in new.items():
        changed = replace_block(text, name, body)
        if changed is None:
            log(f"  {path.name}: no block '{name}' - skipped")
            continue
        text = changed
        done.append(name)
        log(f"  {path.name}: block '{name}' regenerated")
    path.write_text(text)
    print(json.dumps({"metric": "doc_tables", "blocks": done,
                      "readme": str(path), "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
