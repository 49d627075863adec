"""The cross-shard gallery query split into scoring and gather + merge, per
group size (the JAX package's `tools/profile_gallery.py`).

At each n ranks (`bench_pod.py`'s groups: n spawned processes, NCCL on
the cards or gloo on the CPU, each rank a block of `--scenes-per-device`
scenes of the populated gallery of `bench_pod.py::gallery_state`) it
times both forms of the query:

  local  - each rank's scoring and local top-k only
           (`parallel/gallery.py::local_gallery_query`: the product over
           its block, no collective);
  global - the full query (`global_gallery_query`: the same scoring, then
           one all_gather of the n x Q x k candidates and the global
           top-k merge).

global - local is the gather + merge layer.  Each measurement is a run of
`--calls` query calls between CUDA events after a barrier, the slowest
rank's time (`bench_pod.py::measure_once`); the forms alternate, and each
figure is the median of `--point-reps` measurements with its spread.  The
row also gives the gathered payload, n x Q x k x 16 bytes (four 4-byte
arrays per candidate).  The JAX tool's interconnect transfer bound was a
TPU figure and is not carried over.

Run: python -m similari_tpu_torch.tools.profile_gallery [--device cuda|cpu]
         [--devices N] [--counts 1 2 4]
On the cards N defaults to every card, on the CPU to 4.  Prints a table
on stderr and one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from .. import bench_pod as pod
from ..bench_interactive import device_line
from ..device import resolve_device
from ..parallel.gallery import global_gallery_query, local_gallery_query

FORMS = ("global", "local")


def rank_profile(mesh, spec: pod.PodSpec) -> dict:
    """{form: seconds of each measured run} of both query forms on this
    rank's block, after one warm-up run of each."""
    state, queries = pod.gallery_state(mesh, spec)
    points = {}
    for form, make in (("global", global_gallery_query),
                       ("local", local_gallery_query)):
        qfn = make("cosine", spec.topk, mesh)

        def run(st, qfn=qfn):
            out = None
            for i in range(spec.base_len):
                out = qfn(st, queries + float(i) * 1e-6)
            return out

        points[form] = pod.Point(lambda: state, run, spec.base_len)
        run(state)
    samples = {form: [] for form in FORMS}
    for _ in range(spec.point_reps):
        for form in FORMS:
            samples[form].append(pod.measure_once(mesh, points[form],
                                                  state)[0])
    return samples


def profile_row(n: int, spec: pod.PodSpec, samples: dict) -> dict:
    calls = spec.base_len
    full = [s / calls for s in samples["global"]]
    loc = [s / calls for s in samples["local"]]
    f_med, l_med = statistics.median(full), statistics.median(loc)
    return {
        "full_ms": round(f_med * 1e3, 4),
        "full_spread_ms": [round(min(full) * 1e3, 4),
                           round(max(full) * 1e3, 4)],
        "scoring_ms": round(l_med * 1e3, 4),
        "scoring_spread_ms": [round(min(loc) * 1e3, 4),
                              round(max(loc) * 1e3, 4)],
        "gather_merge_ms": round((f_med - l_med) * 1e3, 4),
        "gather_payload_bytes": n * spec.queries * spec.topk * 16,
        "qps_total": round(spec.queries / f_med, 1),
        "gallery_lanes": (spec.scenes_per_device * n * 2 * spec.objects
                          * pod.GALLERY),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--counts", type=int, nargs="*", default=None,
                    help="group sizes to run (default 1, 2, 4 .. devices)")
    ap.add_argument("--scenes-per-device", type=int, default=32)
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--feat-dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--calls", type=int, default=64,
                    help="query calls in a measured run")
    ap.add_argument("--point-reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n_max = args.devices or cards
        if n_max > cards or max(args.counts or [0]) > cards:
            raise ValueError(f"more ranks than the {cards} cards: ranks "
                             "never share a card")
    else:
        n_max = args.devices or 4
    counts = args.counts or pod.rank_counts(n_max)
    card = device_line(dev)
    pod.log(f"device {card}; groups of {counts} ranks")
    rows, errors = {}, {}
    for n in counts:
        spec = pod.PodSpec(("gallery",), args.scenes_per_device,
                           args.objects, args.feat_dim, args.calls,
                           args.point_reps, args.queries, args.topk)
        try:
            samples = pod.run_ranks(n, dev.type, spec, rank_profile)[0]
        except Exception as e:  # recorded; the run goes on and exits 1
            pod.log(f"the group of {n} FAILED: {e}")
            errors[f"n{n}_error"] = repr(e)[:200]
            continue
        r = rows[f"n{n}"] = profile_row(n, spec, samples)
        pod.log(f"n={n}: full {r['full_ms']:8.4f} ms  scoring "
                f"{r['scoring_ms']:8.4f} ms  gather+merge "
                f"{r['gather_merge_ms']:8.4f} ms  payload "
                f"{r['gather_payload_bytes'] / 1024:.0f} KiB  qps "
                f"{r['qps_total']:10.1f} over {r['gallery_lanes']} lanes")
    blob = {"metric": "gallery_query_profile", "platform": dev.type,
            "device": card, "config": vars(args), "rows": {**rows, **errors}}
    print(json.dumps(blob))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
