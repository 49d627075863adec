"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: a few
scenes or short sequences, the same configuration and traffic model."""

import torch

from perfbench import harness

TINY = {
    "vsort512_stream_s1024": dict(scenes=3, check_scenes=2, warm_frames=2),
    "sort_iou_stream_s4096": dict(scenes=4, check_scenes=2, warm_frames=2),
    "vsort512_crowd_s256": dict(scenes=2, check_scenes=2, warm_frames=2),
    "vsort512_replay_mot17": dict(sequences=3, length=[32, 48],
                                  check_sequences=2, warm_sequences=1),
}
CPU = torch.device("cpu")


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, **TINY[name])
    return cell


def run_tiny(name: str, seed: int, control=None, seconds: float = 1.0,
             patch=None):
    """(numbers compared, limits, run record) of a tiny run on the CPU;
    `patch(driver)` may break the timed path after set-up."""
    from perfbench.reference import check as chk

    torch.set_num_threads(2)
    cell = tiny_cell(name)
    drv = harness.driver(cell).Driver(cell, seed, CPU, control)
    drv.setup()
    if patch is not None:
        patch(drv)
    run = drv.window(seconds, False)
    readings = drv.check()
    return chk.numbers(readings, cell.visual), cell.mix["limits"], run


def correct(nums, limits) -> bool:
    return all(nums[k] <= limits[k] for k in nums)
