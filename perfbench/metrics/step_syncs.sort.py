"""The host's waits on the device a batched SORT step call: syncs counted
at every `wait` site inside the port's span `batched_sort_step`, over its
calls (`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    return program_trace.syncs_per_call("batched_sort_step")
