"""Host ms a batched VisualSORT step call spends issuing its work: the
port's span `batched_visual_step` less its `wait` spans, over its calls
(`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.launch_ms("batched_visual_step")
