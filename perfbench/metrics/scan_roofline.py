"""The least time of the traced sequences' work (`perfbench/work.py`, per
frame: detections and live tracks) over the device busy time of the fused
scan calls, in % (`perfbench/readers.py::step_roofline`)."""

from perfbench import readers


def read(run):
    return readers.step_roofline(run, "perfbench.scan")
