"""The port's whole-sequence SORT runner on a MOT det csv path
(`eval/mot.py::run_sequence_device`, the file read by the C++ loader
`native.py::load_sequence_soa`) against the JAX package's, on the CPU.

A MOT det file may have 6 columns (no confidence: read as 1.0) or a
header line (skipped).  On each, with the fused engine (its plain
version) and the general step, the port's ids equal the JAX package's
run of the same path, call for call, the reported boxes at
torch_parity.RTOL/ATOL; and the path's run equals the port's run of the
same detections in memory.
"""

import numpy as np
import pytest

from similari_tpu.eval import mot as jmot
from similari_tpu_torch.eval import mot as pmot

from torch_parity import ATOL, RTOL, one_cpu_thread, write_mot_det

one_cpu_thread()

# frame numbers with a gap; a box leaves and comes back
FRAMES = [1, 2, 3, 4, 5, 7, 8, 9]
N_OBJ, CAPACITY = 6, 64
FILES = {"six_columns": dict(columns=6),
         "header_line": dict(columns=7, header=True),
         "seven_columns": dict(columns=7)}


def _detections(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (N_OBJ, 2))
    wh = rng.uniform(25, 60, (N_OBJ, 2))
    dets = {}
    for f in FRAMES:
        xy = xy + rng.uniform(-3, 3, xy.shape)
        keep = [i for i in range(N_OBJ) if not (f in (3, 4) and i == 2)]
        dets[f] = [(round(float(xy[i, 0]), 2), round(float(xy[i, 1]), 2),
                    round(float(wh[i, 0]), 2), round(float(wh[i, 1]), 2),
                    round(float(rng.uniform(0.4, 1.0)), 4)) for i in keep]
    return dets


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mot")
    dets = _detections()
    out = {}
    for name, kw in FILES.items():
        path = root / f"{name}.txt"
        held = write_mot_det(path, dets, **kw)
        jax_out, _ = jmot.run_sequence_device(path, capacity=CAPACITY)
        out[name] = (path, held, jax_out)
    return out


def _assert_same(want, got):
    assert sorted(want) == sorted(got)
    for f in want:
        assert [r[0] for r in got[f]] == [r[0] for r in want[f]], f"frame {f}"
        np.testing.assert_allclose(np.array([r[1:] for r in got[f]]),
                                   np.array([r[1:] for r in want[f]]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["fused", "step"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_file_route_gives_the_jax_packages_ids(files, name, engine):
    path, held, jax_out = files[name]
    out, fps = pmot.run_sequence_device(path, capacity=CAPACITY,
                                        device="cpu", engine=engine)
    _assert_same(jax_out, out)
    assert fps > 0
    ids = {r[0] for rows in out.values() for r in rows}
    assert len(ids) >= N_OBJ and sorted(out) == FRAMES


@pytest.mark.parametrize("name", sorted(FILES))
def test_file_route_equals_the_in_memory_run(files, name):
    path, held, _ = files[name]
    from_file, _ = pmot.run_sequence_device(path, capacity=CAPACITY,
                                            device="cpu")
    in_memory, _ = pmot.run_sequence_device(held, capacity=CAPACITY,
                                            device="cpu")
    assert from_file == in_memory


def test_six_columns_read_as_full_confidence(files):
    from similari_tpu_torch.eval import load_sequence_soa

    frames, box, conf, valid = load_sequence_soa(files["six_columns"][0])
    assert frames.tolist() == FRAMES
    assert (conf[valid] == 1.0).all() and (conf[~valid] == 0.0).all()
    assert valid.sum() == sum(len(v) for v in _detections().values())
    assert box.shape == (len(FRAMES), 8, 5)
