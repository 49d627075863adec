"""Host ms of one fused VisualSORT chunk call (the port's span
`fused_visual_chunk`: the state clone, `gallery_dots` and the frame
loop's launch, no sync inside), over its calls
(`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.host_ms("fused_visual_chunk")
