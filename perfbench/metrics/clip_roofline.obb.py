"""`csrc/clip.cu::clip_pairs_kernel` on the traced steps of the oriented
cell: the least time of the clip's work (`perfbench/work_oriented.py`:
CLIP_OPS a pair of a valid detection and a live track whose enclosing
circles meet, at the float32 peak; 32 bytes a valid detection and a live
track read and 4 bytes an in-radius pair written, at the HBM peak) over
the kernel's device time, in %."""

from perfbench import harness, peaks, work_oriented

NAME = "clip_pairs_kernel"


def read(run):
    prof = run.get("profile")
    if not prof or "pairs" not in run:
        return None
    dev_s, launches = prof.kernel(NAME)
    if not launches:
        return None
    ops = nbytes = 0.0
    for pairs, valid, alive in run["pairs"]:
        o, b = work_oriented.clip_work(pairs, valid, alive)
        ops, nbytes = ops + o, nbytes + b
    least, bound = peaks.least_time(ops, nbytes)
    harness.log(f"clip_roofline.obb: bound by {bound}; {launches} launches, "
                f"{dev_s * 1e3:.6f} ms device, least {least * 1e3:.6f} ms")
    return 100.0 * least / dev_s
