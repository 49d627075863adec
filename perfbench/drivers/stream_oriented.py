"""Closed-loop streams of rotated boxes: the `stream` driver with the
oriented traffic (`perfbench/traffic_oriented.py`) and the oriented
reference (`perfbench/reference/oriented.py`) in place of the aligned
ones; the port's step is `parallel/mesh.py::batched_sort_step` as there.

In the traced steps only, inside the driver's `perfbench.count` range
(outside the step's span), it keeps copies of each frame's boxes and
valid rows and of the tracks' predicted boxes and live slots, a few MB;
after the window it counts each scene's in-radius pairs of valid
detections and live tracks from them (`perfbench/work_oriented.py`), for
`clip_roofline.obb`, so the device runs nothing of the benchmark's own in
the window but those copies.  After the window it also logs the port's
clip launches and dense oriented IoU calls a step where the port counts
them.

On CUDA this cell measures the batched clip path: its first warm step must
raise the port's `clip.launches` count.  A port whose batched step scores
the rotated pairs densely instead (before the sorted path took a scene
axis) launches none there, and the run exits 1 with no result, within
its first step, rather than time a different algorithm under this cell's
name.

Controls (the planted faults of `perfbench/tests/`): "program_aligned"
runs the port with `oriented` false, axis-aligned IoU on the same boxes;
"reference_bf16_boxes" gives the reference the boxes rounded to
bfloat16.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench import harness, program_trace, work_oriented
from perfbench.drivers import stream
from perfbench.reference import oriented
from perfbench.swap import swapped
from perfbench.traffic_oriented import OrientedScenes


class _PairCounts:
    """The traced steps' list of (valid, alive) counts: each entry the base
    driver appends, inside its `perfbench.count` range, also keeps the
    frame's and the tracks' boxes in the driver's `pair_inputs`."""

    def __init__(self, counts: list, driver: "Driver"):
        self.counts, self.driver = counts, driver

    def append(self, item) -> None:
        self.counts.append(item)
        drv = self.driver
        st = drv.state
        idle = drv.cell.config["settings"]["max_idle_epochs"]
        alive = st.active & (drv.epoch - st.last_epoch <= idle)
        fr = drv.gen.last
        drv.pair_inputs.append((fr.box.clone(), fr.valid.clone(),
                                st.pred_box.clone(), alive))


def require_clip_launch(before, after) -> None:
    """Exit 1, with no result, unless the port's `clip.launches` count rose
    between the records `before` and `after` (`program_trace.summary()`,
    None where the port keeps no records)."""
    if before is None or after is None:
        ran = None
    else:
        ran = (after["counts"].get("clip.launches", 0)
               - before["counts"].get("clip.launches", 0))
    if not ran:
        harness.log("the port counted no clip launch in the first oriented "
                    "step: it does not run the batched clip path this cell "
                    "measures; no result")
        raise SystemExit(1)


def _pairs(det_box, det_valid, trk_box, trk_alive, chunk: int = 16):
    """`work_oriented.in_radius_pairs` over `chunk` scenes at a time, as
    host arrays: its [chunk, D, T] temporaries stay small."""
    parts = [work_oriented.in_radius_pairs(det_box[i:i + chunk],
                                           det_valid[i:i + chunk],
                                           trk_box[i:i + chunk],
                                           trk_alive[i:i + chunk])
             for i in range(0, det_box.shape[0], chunk)]
    return tuple(torch.cat(x).cpu().numpy() for x in zip(*parts))


class _LastFrame(OrientedScenes):
    """The oriented scenes, keeping the last frame made."""

    def step(self):
        self.last = super().step()
        return self.last


class Driver(stream.Driver):
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device,
                 control=None):
        self.ref_cell = cell  # the configuration the reference runs
        if control == "program_aligned":
            s = dict(cell.config["settings"], oriented=False)
            cell = dataclasses.replace(cell, config=dict(cell.config,
                                                         settings=s))
        super().__init__(cell, seed, device, control)
        self.pair_inputs: list = []

    def setup(self) -> None:
        with swapped(stream, Scenes=_LastFrame):
            super().setup()

    def _step(self, counts=None):
        first = (self.epoch == 0 and self.dev.type == "cuda"
                 and self.cell.config["settings"]["oriented"])
        before = first and program_trace.summary()
        out = super()._step(None if counts is None
                            else _PairCounts(counts, self))
        if first:
            require_clip_launch(before, program_trace.summary())
        return out

    def window(self, seconds: float, trace: bool):
        summ = program_trace.summary()
        before = summ and summ["counts"]
        run = super().window(seconds, trace)
        if self.pair_inputs:
            run["pairs"] = [_pairs(*x) for x in self.pair_inputs]
            self.pair_inputs = []
        after = program_trace.summary()
        if before is not None and after is not None:
            n = run["frames"]
            for name in ("clip.launches", "geometry.oriented_dense"):
                got = after["counts"].get(name, 0) - before.get(name, 0)
                harness.log(f"{name}: {got / max(n, 1):.4f} a step over "
                            f"{n} steps")
        return run

    def check(self):
        if self.control == "reference_bf16_boxes":
            for k in self.kept:
                k["box"] = k["box"].to(torch.bfloat16).float()
        self.cell, program_cell = self.ref_cell, self.cell
        try:
            with swapped(stream, chk=oriented):
                return super().check()
        finally:
            self.cell = program_cell
