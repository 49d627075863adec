"""`csrc/gallery_dots.cu::gallery_dots_kernel` (the float32 product) on
the traced sequences: per launch, the products the scan reads, counted
from the frames' valid rows and not from the padded ones the kernel is
given: the chunk's valid rows against the live lanes at the chunk's
start, and each valid row against the valid rows of the chunk's earlier
frames, 2F operations each plus the norms, at the float32 peak; those
rows and lanes read once, their products and norms written once at the
HBM peak.  Over the kernel's device time, in %."""

import numpy as np

from perfbench import harness, peaks

NAME = "gallery_dots_kernel"


def read(run):
    prof = run.get("profile")
    if not prof or "work" not in run:
        return None
    dev_s, launches = prof.kernel(NAME)
    if not launches:
        return None
    sh = run["shape"]
    f, k, c = sh["feature_dim"], sh["gallery"], sh["chunk"]
    ops = nbytes = 0.0
    for valid, alive in run["work"]:
        v = np.asarray(valid, np.float64)
        a = np.asarray(alive, np.float64)
        for i in range(0, len(v), c):
            rows = v[i:i + c]
            n, m = rows.sum(), a[i] * k
            # valid rows of a frame against those of each earlier frame
            pairs = (n * n - (rows * rows).sum()) / 2
            needed = n * m + pairs
            ops += 2 * f * needed + 2 * f * (n + m)
            nbytes += 4 * ((n + m) * f + needed + (n + m))
    least, bound = peaks.least_time(ops, nbytes)
    harness.log(f"gallery_dots_roofline: bound by {bound}; {launches} "
                f"launches, {dev_s * 1e3:.6f} ms device, least "
                f"{least * 1e3:.6f} ms")
    return 100.0 * least / dev_s
