"""The benchmark of the PyTorch/CUDA port: one cell of BENCHMARK.json, one
run, one JSON line on standard output.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in `setup_s`) builds or loads the port's kernel library,
makes the cell's traffic on the device from the seed and warms the cell's
own shapes; the window then runs for S seconds; after it the peak device
memory is read, the program's state freed and what the window produced is
held to the plain reference (`perfbench/reference/`), which decides
`correct`.  With --trace 1 one torch.profiler profile covers a fixed
stretch from the middle of the window, and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

Without a CUDA device, or with fewer than the cell asks for, the run
exits 1 and prints no result; so does a run in whose process a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness
    from perfbench.reference import check as chk

    cell = harness.load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    drv = harness.driver(cell).Driver(cell, args.seed, dev)
    drv.setup()
    setup_s = time.perf_counter() - START
    harness.log(f"set-up {setup_s:.3f} s (kernel library "
                f"{drv.notes.get('build_s', 0.0):.3f} s)")
    trace = bool(args.trace)
    with harness.no_gc():
        run = drv.window(args.seconds, trace)
    run["setup_s"] = setup_s
    device = harness.device_info(chips)
    harness.log(f"window {run['window_s']:.3f} s, {run['frames']} frames; "
                f"generator share {run['gen_share']:.4f} of the window")
    t0 = time.perf_counter()
    readings = drv.check()
    nums = chk.numbers(readings, cell.visual)
    limits = cell.mix["limits"]
    correct = all(nums[k] <= limits[k] for k in nums)
    harness.log(f"check {time.perf_counter() - t0:.3f} s: {readings.frames} "
                f"frames, {readings.rows} rows compared, {readings.ties} "
                f"frames on an equal optimum")
    if readings.detail:
        harness.log(f"first disagreement: {readings.detail}")
    metrics = harness.read_metrics(cell, trace, run)
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    prof = run.get("profile")
    if trace:
        if prof is None:
            harness.log("the window was too short for the traced stretch")
            return 1
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops,
                               "idle_gaps": prof.idle_gaps}
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {', '.join(found)}")
        return 1
    result["check"] = {k: {"value": v, "limit": limits[k]}
                       for k, v in nums.items()}
    for k, v in nums.items():
        harness.log(f"{k} {v!r} limit {limits[k]!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
