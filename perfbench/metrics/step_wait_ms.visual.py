"""Host ms a batched VisualSORT step call spends blocked on the device:
the time inside `wait` spans of the port's span `batched_visual_step`,
over its calls (`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.wait_ms("batched_visual_step")
