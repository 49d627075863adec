"""`csrc/merge.cu::lane_merge_kernel` on the traced steps: each written
feature row read from its source and written to the state once, with the
row and mask words, at the HBM peak, over the kernel's device time, in %."""

from perfbench import harness, peaks

NAME = "lane_merge_kernel"


def read(run):
    prof = run.get("profile")
    if not prof or "work" not in run:
        return None
    dev_s, launches = prof.kernel(NAME)
    if not launches:
        return None
    sh = run["shape"]
    row = sh["feature_dim"] * 4
    nbytes = 0.0
    for valid, _alive in run["work"]:
        rows = float(valid.sum())
        # two launches a step: the gallery lanes, then the history ring
        nbytes += 2 * (2 * rows * row + 8 * sh["scenes"] * sh["dpad"])
    least, _ = peaks.least_time(0.0, nbytes)
    harness.log(f"merge_roofline: {launches} launches, {dev_s * 1e3:.6f} ms "
                f"device, least {least * 1e3:.6f} ms")
    return 100.0 * least / dev_s
