"""The fused engines' shape check (`ops/fused_sort.py::check_sort_shape`,
`ops/fused_visual.py::check_visual_shape`), on the CPU.

A shape the CUDA kernels do not take (more than 1024 rows per frame, or a
block's shared arrays past 232,448 bytes) raises ValueError naming
engine="step" before any launch, on every device: the chunk wrappers run
their plain versions on the CPU only for shapes the kernels take, and the
runners check before their first chunk.  The general step runs the same
shapes.  The Python count of shared bytes mirrors the kernels' `carve`; the
card test `test_torch_cuda.py::test_shape_check_counts_the_library_bytes`
holds it against the library.
"""

import numpy as np
import pytest
import torch

from similari_tpu_torch.eval import mot as pmot
from similari_tpu_torch.ops import fused_sort as fs
from similari_tpu_torch.ops import fused_visual as fv
from similari_tpu_torch.trackers.sort_step import SortConfig
from similari_tpu_torch.trackers.state import new_sort_state
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import VisualConfig

from torch_parity import VISUAL_CONFIGS, one_cpu_thread

one_cpu_thread()

CPU = torch.device("cpu")
STEP = 'engine="step"'
SORT_CFG = SortConfig(method="iou", oriented=False)
VISUAL_CFG = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])


def _last_fitting_slots(d, k):
    """The most slots whose VisualSORT shared arrays fit at D=d, K=k, with
    every slice in device memory where it must."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        t = (lo + hi + 1) // 2
        lo, hi = (t, hi) if fv.visual_storage(d, t, k)[0] >= 0 else (lo, t - 1)
    return lo


def _sort_inputs(c, d):
    return (torch.zeros((c, d, 5)), torch.zeros((c, d)),
            torch.zeros((c, d), dtype=torch.int32))


def _visual_inputs(c, d, f):
    z = torch.zeros((c, d))
    return (torch.zeros((c, d, 5)), z, z.int(), torch.zeros((c, d, f)),
            z.int(), z, z)


def _grid_detections(n, frames):
    """n non-overlapping 10 x 20 boxes on a grid, drifting 1 px a frame."""
    cols = int(np.ceil(np.sqrt(n)))
    return {f: [(40.0 * (i % cols) + f, 40.0 * (i // cols), 10.0, 20.0, 0.9)
                for i in range(n)] for f in range(1, frames + 1)}


def _features(dets, dim):
    rng = np.random.default_rng(0)
    ident = rng.normal(size=(max(len(v) for v in dets.values()), dim))
    return {f: [ident[i].tolist() for i in range(len(v))]
            for f, v in dets.items()}


# D, T and the storage `fused_sort_chunk.plan` reported on the card for
# the card test's SORT cases (`test_torch_cuda.py::SORT_CASES`), with the
# shared bytes of the main path's shape (PERF.md: 70,512)
@pytest.mark.parametrize("d,t,storage", [
    (1, 200, 7), (128, 500, 7), (128, 2000, 7), (1024, 512, 6),
    (1024, 2000, 6), (1024, 4000, 4), (1024, 8000, 0)])
def test_sort_storage_mirrors_the_kernels_plan(d, t, storage):
    assert fs.sort_storage(d, t)[0] == storage
    assert fs.sort_storage(128, 512) == (7, 70512)


@pytest.mark.parametrize("d,t", [(1025, 8), (1024, 24000)])
def test_sort_chunk_refuses_shapes_the_kernel_does_not_take(d, t):
    """More rows than the block's threads, or a state past shared memory
    with every slice in device memory."""
    st = fs.state_to_tuple(new_sort_state(t, 1, device=CPU))
    with pytest.raises(ValueError, match=STEP):
        fs.fused_sort_chunk(SORT_CFG, st, *_sort_inputs(1, d), 1)


def test_sort_chunk_runs_the_largest_shape_the_kernel_takes():
    st = fs.state_to_tuple(new_sort_state(8, 1, device=CPU))
    out = fs.fused_sort_chunk(SORT_CFG, st, *_sort_inputs(1, 1024), 1)
    assert out[1].shape == (1, 1024)


def test_visual_shared_bytes_limit_slots():
    """The plan at the main path's shape (everything in shared memory),
    and the slots that fit (51,200 at D=128, K=3; 31,552 at K=8; 12,816
    at D=1024), past the one-block kernel's 2,573, 1,500 and 1,252."""
    assert fv.visual_storage(128, 512, 3) == (7, 82096)
    assert _last_fitting_slots(128, 3) == 51200
    assert _last_fitting_slots(128, 8) == 31552
    assert _last_fitting_slots(1024, 3) == 12816


@pytest.mark.parametrize("case", ["rows", "lanes", "shared"])
def test_visual_chunk_refuses_shapes_the_kernel_does_not_take(case):
    d, t, k, f = {"rows": (1025, 8, 3, 4), "lanes": (8, 8, 32, 4),
                  "shared": (128, _last_fitting_slots(128, 3) + 1, 3, 4)}[case]
    st = fv.state_to_tuple(new_visual_state(t, 1, k, f, device=CPU))
    with pytest.raises(ValueError, match=STEP):
        fv.fused_visual_chunk(VISUAL_CFG, st, *_visual_inputs(1, d, f), 1)


def test_visual_chunk_runs_at_the_shared_memory_limit():
    t = _last_fitting_slots(128, 3)
    st = fv.state_to_tuple(new_visual_state(t, 1, 3, 4, device=CPU))
    out = fv.fused_visual_chunk(VISUAL_CFG, st, *_visual_inputs(1, 128, 4), 1)
    assert out[1].shape == (1, 128)


@pytest.fixture(scope="module")
def crowd():
    """Two frames of 1025 detections: padded to D = 2048 rows."""
    dets = _grid_detections(1025, 2)
    return dets, _features(dets, 4)


def test_sort_runner_checks_before_any_chunk(crowd):
    dets, _ = crowd
    with pytest.raises(ValueError, match=STEP):
        pmot.run_sequence_device(dets, capacity=1100, device="cpu")


def test_visual_runner_checks_before_any_chunk(crowd):
    dets, feats = crowd
    with pytest.raises(ValueError, match=STEP):
        pmot.run_sequence_device_visual(dets, feats, capacity=1100,
                                        gallery=1, device="cpu")
    small = {f: v[:3] for f, v in dets.items()}
    t = _last_fitting_slots(pmot._pad_pow2(3), 3) + 1
    with pytest.raises(ValueError, match=STEP):
        pmot.run_sequence_device_visual(small, _features(small, 4),
                                        capacity=t, gallery=3, device="cpu")


def test_step_engines_run_the_shapes_the_fused_ones_refuse(crowd):
    """1025 detections a frame keep their ids on the general steps; so do
    three detections against a state past the fused kernel's shared
    memory."""
    dets, feats = crowd
    out, _ = pmot.run_sequence_device(dets, capacity=1100, device="cpu",
                                      engine="step")
    ids = [[r[0] for r in out[f]] for f in (1, 2)]
    assert len(set(ids[0])) == 1025 and ids[0] == ids[1]
    out, _ = pmot.run_sequence_device_visual(
        dets, feats, capacity=1100, gallery=1, device="cpu", engine="step")
    ids = [[r[0] for r in out[f]] for f in (1, 2)]
    assert len(set(ids[0])) == 1025 and ids[0] == ids[1]
    small = {f: v[:3] for f, v in dets.items()}
    t = _last_fitting_slots(pmot._pad_pow2(3), 3) + 1
    out, _ = pmot.run_sequence_device_visual(
        small, _features(small, 4), capacity=t, gallery=3, device="cpu",
        engine="step")
    assert [r[0] for r in out[1]] == [r[0] for r in out[2]]
