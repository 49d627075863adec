"""`csrc/fused_track.cu::fused_visual_kernel` on the traced sequences:
the frame loop's work without the gallery products (made before it by
`gallery_dots`): per frame the detection rows and their outputs, the
product of each detection with each live lane read once, a lane and a
history row written per detection; per launch the live tracks' state read
and written once.  Against the float32 and HBM peaks, over the kernel's
device time, in %."""

import numpy as np

from perfbench import harness, peaks, work

NAME = "fused_visual_kernel"


def read(run):
    prof = run.get("profile")
    if not prof or "work" not in run:
        return None
    dev_s, launches = prof.kernel(NAME)
    if not launches:
        return None
    sh = run["shape"]
    f, k, c = sh["feature_dim"], sh["gallery"], sh["chunk"]
    ops = words = 0.0
    for valid, alive in run["work"]:
        v = np.asarray(valid, np.float64)
        a = np.asarray(alive, np.float64)
        ops += float((work.IOU_OPS * v * a + 3 * v * a * k).sum())
        words += float((v * (work.ROW_WORDS + work.OUT_WORDS) + v * a * k
                        + v * f + 2 * v * f).sum())
        starts = a[::c]
        words += float((2 * starts * (work.STATE_WORDS + k * f)).sum())
    least, bound = peaks.least_time(ops, 4.0 * words)
    harness.log(f"fused_visual_roofline: bound by {bound}; {launches} "
                f"launches, {dev_s * 1e3:.6f} ms device, least "
                f"{least * 1e3:.6f} ms")
    return 100.0 * least / dev_s
