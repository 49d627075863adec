"""Auction rounds a batched SORT step in the oriented cell: the port's
counter `auction.rounds` over the calls of its span `batched_sort_step`,
every step of the process (`perfbench/program_trace.py`)."""

from perfbench import program_trace


def read(run):
    summ = program_trace.summary()
    step = program_trace.span("batched_sort_step")
    if not summ or step is None or "auction.rounds" not in summ["counts"]:
        return None
    return summ["counts"]["auction.rounds"] / step["calls"]
