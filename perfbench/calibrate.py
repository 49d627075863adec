"""The readings that the limits of `correct` are set from: in one process,
the program on many seeds, then each control on a few, every one through
the cell's own driver at the cell's own size and window.

    python3 perfbench/calibrate.py --workload NAME --seconds S \
        --seeds 11,12,... [--controls program_bf16,reference_bf16 \
        --control-seeds 21,22,23]

Controls: `program_bf16` runs the port with its bfloat16 gallery
(`feature_precision="bf16"`, gallery and history stored in bfloat16);
`reference_bf16` puts the reference, its state kept in bfloat16, in the
program's place.  Prints one JSON line per run on standard output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=ints, required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=ints, default=[])
    args = p.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.reference import check as chk

    if not torch.cuda.is_available():
        harness.log("calibration measures on a CUDA device")
        return 1
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(None, s) for s in args.seeds]
    runs += [(c, s) for c in args.controls.split(",") if c
             for s in args.control_seeds]
    for control, seed in runs:
        t0 = time.perf_counter()
        drv = harness.driver(cell).Driver(cell, seed, dev, control)
        drv.setup()
        with harness.no_gc():
            run = drv.window(args.seconds, False)
        readings = drv.check()
        line = {"workload": args.workload, "control": control, "seed": seed,
                "frames": run["frames"], "failed": run["failed"],
                "compared_frames": readings.frames,
                "compared_rows": readings.rows, "ties": readings.ties,
                "numbers": chk.numbers(readings, cell.visual),
                "kf_fields": {k: readings.kf_diff[k]
                              / max(readings.kf_scale[k], 1e-30)
                              for k in readings.kf_diff},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
