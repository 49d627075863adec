"""The host's waits on the device a batched VisualSORT step call: syncs
counted at every `wait` site inside the port's span `batched_visual_step`,
over its calls (`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.syncs_per_call("batched_visual_step")
