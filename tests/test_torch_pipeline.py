"""The port's whole-sequence runners (`similari_tpu_torch.eval.mot`, on the
CPU through the kernels' plain versions) against the JAX package's
`engine="pallas"` runners, on sequences with gaps in the frame numbers.

Track ids must be equal; reported boxes are held at 1e-4 (they are KF
outputs for SORT, and copies of the input for VisualSORT).
"""

import inspect

import numpy as np
import pytest
import torch

from similari_tpu.eval import mot as jmot
from similari_tpu_torch import resolve_device
from similari_tpu_torch.eval import mot as pmot
from similari_tpu_torch.trackers.state import new_sort_state

from torch_parity import one_cpu_thread

one_cpu_thread()

# frame numbers with gaps of 1 and 3 missing frames
FRAMES = [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 15]
N_OBJ, FDIM = 6, 8


def _sequence(seed=0, with_features=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (N_OBJ, 2))
    wh = rng.uniform(30, 50, (N_OBJ, 2))
    ident = rng.normal(size=(N_OBJ, FDIM))
    dets, feats, quals = {}, {}, {}
    for f in FRAMES:
        xy = xy + rng.uniform(-2, 2, xy.shape)
        n = N_OBJ - (f % 3 == 0)  # some frames miss the last object
        dets[f] = [(float(xy[i, 0]), float(xy[i, 1]), float(wh[i, 0]),
                    float(wh[i, 1]), float(rng.uniform(0.5, 1.0)))
                   for i in range(n)]
        feats[f] = [None if (f == 5 and i == 0) else
                    (ident[i] + 0.05 * rng.normal(size=FDIM)).tolist()
                    for i in range(n)]
        quals[f] = rng.uniform(0.3, 1.0, n).tolist()
    return dets, feats, quals


def _assert_same(out_j, out_p, tol=1e-4):
    assert sorted(out_j) == sorted(out_p)
    for f in out_j:
        ids_j = [r[0] for r in out_j[f]]
        ids_p = [r[0] for r in out_p[f]]
        assert ids_j == ids_p, f"frame {f}"
        np.testing.assert_allclose(np.array([r[1:] for r in out_p[f]]),
                                   np.array([r[1:] for r in out_j[f]]),
                                   rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def sort_runs():
    dets, _, _ = _sequence(0)
    out_j, _ = jmot.run_sequence_device(dets, engine="pallas", capacity=16)
    out_p, fps = pmot.run_sequence_device(dets, capacity=16, device="cpu")
    return dets, out_j, out_p, fps


def test_run_sequence_device_matches_pallas(sort_runs):
    _, out_j, out_p, fps = sort_runs
    _assert_same(out_j, out_p)
    assert fps > 0


def test_run_sequence_device_keeps_ids_across_gaps(sort_runs):
    """Gaps of up to 3 frames stay under max_idle_epochs=5: every object
    keeps its first id."""
    _, _, out_p, _ = sort_runs
    first = [r[0] for r in out_p[FRAMES[0]]]
    for f in FRAMES:
        assert [r[0] for r in out_p[f]] == first[:len(out_p[f])]


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_run_sequence_device_visual_matches_pallas(precision):
    dets, feats, quals = _sequence(1)
    kw = dict(capacity=16, feature_precision=precision, qualities=quals,
              visual_minimal_quality_use=0.4)
    out_j, _ = jmot.run_sequence_device_visual(dets, feats, engine="pallas",
                                               **kw)
    out_p, fps = pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                                 **kw)
    _assert_same(out_j, out_p)
    assert fps > 0


def test_csv_path_input(tmp_path, sort_runs):
    """A MOT det csv gives the same result as the parsed dict."""
    dets, _, out_p, _ = sort_runs
    path = tmp_path / "det.txt"
    path.write_text("".join(
        f"{f},-1,{l!r},{t!r},{w!r},{h!r},{c!r},-1,-1,-1\n"
        for f in FRAMES for (l, t, w, h, c) in dets[f]))
    out_csv, _ = pmot.run_sequence_device(path, capacity=16, device="cpu")
    _assert_same(out_p, out_csv, tol=0)


def test_helpers_match_jax():
    rng = np.random.default_rng(2)
    for cols in (5, 6, 10):
        dets = rng.uniform(1, 50, (7, cols)).astype(np.float32)
        np.testing.assert_array_equal(pmot.ltwh_to_vec5(dets),
                                      jmot.ltwh_to_vec5(dets))
    v = rng.uniform(1, 50, (7, 5)).astype(np.float32)
    np.testing.assert_array_equal(pmot.vec5_to_ltwh(v), jmot.vec5_to_ltwh(v))
    a = rng.uniform(size=(len(FRAMES), 3)).astype(np.float32)
    pos_p, (e_p,) = pmot._expand_gaps(FRAMES, (a,))
    pos_j, (e_j,) = jmot._expand_gaps(FRAMES, (a,))
    np.testing.assert_array_equal(pos_p, pos_j)
    np.testing.assert_array_equal(e_p, e_j)
    with pytest.raises(RuntimeError, match="overflow at frame index 2"):
        pmot._check_overflow(np.array([0, 0, 1, 1], bool), 8)


def test_out_of_scope_runner_options_raise():
    dets, feats, _ = _sequence(0)
    with pytest.raises(NotImplementedError, match="engine='step'"):
        pmot.run_sequence_device(dets, method="maha", device="cpu")
    # device-computed own-area shares need the general step; the fused
    # engine takes only precomputed (host) shares
    with pytest.raises(ValueError, match="precomputed"):
        pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                        own_area_use=0.2,
                                        own_area_backend="device")


@pytest.mark.parametrize("runner,builder", [
    (pmot.run_sequence_device, pmot.sequence_sort_config),
    (pmot.run_sequence_device_visual, pmot.sequence_visual_config)])
def test_runner_config_builders_share_defaults(runner, builder):
    """The config builders (which chip_smoke.py checks the kernels with)
    take the runners' defaults, and give the config the runners run."""
    run_p = inspect.signature(runner).parameters
    cfg_p = inspect.signature(builder).parameters
    for name, p in cfg_p.items():
        if p.kind is p.VAR_KEYWORD:
            continue
        assert run_p[name].default == p.default, name
    cfg = builder()
    assert cfg.assignment == "auction" and not cfg.oriented
    assert cfg.recycle_idle


@pytest.mark.parametrize("assignment", ["auto", "hungarian"])
def test_runners_reject_other_assignments(assignment):
    """The kernels assign by their auction only; asking for another method
    raises instead of silently running the auction."""
    dets, feats, _ = _sequence(0)
    with pytest.raises(ValueError, match="auction"):
        pmot.run_sequence_device(dets, assignment=assignment, device="cpu")
    with pytest.raises(ValueError, match="auction"):
        pmot.run_sequence_device_visual(dets, feats, assignment=assignment,
                                        device="cpu")


def test_no_silent_cpu_fallback(monkeypatch):
    """`device=None` means CUDA: without it, entry points raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        new_sort_state(8, 1)
    dets, _, _ = _sequence(0)
    with pytest.raises(RuntimeError):
        pmot.run_sequence_device(dets)
