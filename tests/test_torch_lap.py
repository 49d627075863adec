"""The port's host C++ LAP solver (`csrc/lap.cpp`, `ops/lap.py`) and the
`assignment="native"` backend against the JAX package's native solver, on
the CPU.

The two libraries build from the same code with the same flags, so their
columns are bit-equal, ties included; every solution's total equals
scipy's optimum.  A failed build raises (no scipy fallback), and
concurrent first builds do not interleave.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from similari_tpu import native
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.sort_step import compiled_sort_scan
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu_torch import _build
from similari_tpu_torch.convert import sort_state_from_numpy, sort_state_to_numpy
from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.ops.lap import lap_max, lap_max_batch
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan

from torch_parity import (assert_state_dicts_match, crowded_stream,
                          jax_state_dict, one_cpu_thread, oriented_stream)

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]


def _matrix(kind, seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 24))
    if kind == "square":
        return rng.normal(size=(r, r)).astype(np.float32)
    if kind == "rectangular":
        return rng.uniform(0, 1, (r, r + int(rng.integers(1, 30)))).astype(
            np.float32)
    if kind == "ties":  # few distinct values: many equal optima
        return rng.integers(0, 3, (r, r + 3)).astype(np.float32)
    if kind == "sparse":  # voting-shaped: mostly 0, a threshold diagonal
        w = np.zeros((r, 2 * r + 4), np.float32)
        w[np.arange(r), np.arange(r)] = 0.3
        for i in range(r):
            w[i, r + rng.choice(r + 4, 3, replace=False)] = rng.uniform(
                0.2, 1.0, 3)
        return w
    raise KeyError(kind)


def _total(w, cols):
    return float(w[np.arange(len(cols)), cols].astype(np.float64).sum())


@pytest.mark.parametrize("kind", ["square", "rectangular", "ties", "sparse"])
@pytest.mark.parametrize("seed", range(6))
def test_lap_max_is_bit_equal_to_jax_native(kind, seed):
    w = _matrix(kind, seed)
    got = lap_max(w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, native.lap_max(w))
    assert len(set(got.tolist())) == len(got)
    rows, cols = linear_sum_assignment(w, maximize=True)
    assert _total(w, got) == pytest.approx(
        float(w[rows, cols].astype(np.float64).sum()), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("threads", [1, 0, 3])
def test_lap_max_batch_is_bit_equal_to_jax_native(threads):
    rng = np.random.default_rng(7)
    w = rng.integers(0, 4, (9, 6, 11)).astype(np.float32)
    got = lap_max_batch(w, threads)
    np.testing.assert_array_equal(got, native.lap_max_batch(w, threads))
    for b in range(len(w)):
        np.testing.assert_array_equal(got[b], lap_max(w[b]))
    assert lap_max_batch(np.zeros((0, 3, 4), np.float32)).shape == (0, 3)


def test_more_rows_than_columns_raises():
    with pytest.raises(RuntimeError, match="lap_solve_max failed"):
        lap_max(np.ones((3, 2), np.float32))


def test_native_backend_solves_scene_batches():
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.integers(0, 5, (4, 7, 12)).astype(np.float32))
    cols = asg.solve_lap(w, "native")
    assert cols.dtype == torch.int64 and cols.device == w.device
    for s in range(4):
        np.testing.assert_array_equal(cols[s].numpy(),
                                      native.lap_max(w[s].numpy()))
        np.testing.assert_array_equal(asg.solve_lap(w[s], "native").numpy(),
                                      cols[s].numpy())


def test_auto_stays_hungarian_on_the_cpu():
    assert asg.resolve_backend("auto", torch.device("cpu")) == "hungarian"
    assert asg.resolve_backend("native", torch.device("cpu")) == "native"


@pytest.mark.parametrize("cxx", ["/nonexistent/c++", "false"])
def test_failed_build_raises_naming_hungarian(cxx, monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_HOST", _build._Library())
    with pytest.raises(RuntimeError, match="assignment='hungarian'"):
        lap_max(np.ones((2, 3), np.float32))
    assert not list(tmp_path.glob("*.so"))


def test_concurrent_first_builds_do_not_interleave(tmp_path):
    """Three processes build into one empty directory at once; each loads
    a working library and no temporary file is left behind."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from similari_tpu_torch import _build\n"
        "from similari_tpu_torch.ops.lap import lap_max\n"
        "_build.BUILD_DIR = Path(sys.argv[1])\n"
        "w = np.array([[0, 2, 1], [3, 0, 1]], np.float32)\n"
        "print(lap_max(w).tolist())\n")
    env = dict(os.environ)
    env.pop("CXX", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "[1, 0]"
    assert len(list(tmp_path.glob("libsimilari_host_*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def _scan_stream(kind):
    ep = np.arange(1, 9, dtype=np.int32)
    if kind == "crowded":
        return (*crowded_stream(0, 8, 16, 12, 16, 133.0, copies=1)[:3], ep,
                64)
    return (*oriented_stream(1, 8, 8), ep, 32)


@pytest.mark.parametrize("kind,method", [("crowded", "iou"),
                                         ("crowded", "maha"),
                                         ("oriented", "iou")])
def test_native_sort_scan_matches_jax_native(kind, method):
    """The general SORT step with assignment="native" gives the JAX
    package's assignment="native" ids; states at torch_parity's
    tolerance."""
    box, conf, valid, epochs, t = _scan_stream(kind)
    kw = dict(method=method, assignment="native", max_idle_epochs=5,
              oriented=kind == "oriented")
    st = jax_new_sort_state(t, 1)
    start = jax_state_dict(st)
    sj, oj = compiled_sort_scan(JaxSortConfig(**kw))(
        st, jnp.asarray(box), jnp.asarray(conf), jnp.asarray(valid),
        jnp.asarray(epochs))
    sp, op = sort_scan(SortConfig(**kw),
                       sort_state_from_numpy(start, "cpu"),
                       torch.tensor(box), torch.tensor(conf),
                       torch.tensor(valid), epochs)
    for name in ("slot", "track_id", "is_new", "length", "overflow"):
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)),
                                      err_msg=name)
    assert_state_dicts_match(jax_state_dict(sj), sort_state_to_numpy(sp))
    assert (~op.is_new.numpy() & valid).sum() > valid.sum() // 2
