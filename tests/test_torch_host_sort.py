"""The port's host SORT step (`trackers/host_sort.py`) and its rotated IoU
(`trackers/host_geometry.py`) against the JAX package's, on the CPU.

* The port's NumPy twin (`host_sort_step_numpy`) against the JAX module's
  NumPy path (its native step switched off with monkeypatch): outputs and
  states bit-equal, frame by frame.
* The port's step (`host_sort_step`, its C++ step `csrc/sortstep.cpp`)
  against the JAX module's default, native C++ step: outputs and states
  bit-equal, frame by frame.
* The port's C++ step against its NumPy twin: ids, slots, is_new and
  lengths equal, states at torch_parity.RTOL/ATOL.
* Against the port's own device step on the CPU (`sort_step`, scipy's
  exact Hungarian): ids equal; a frame whose solutions differ is accepted
  only if the two voting LP totals tie within torch_parity.LP_TIE_RTOL
  (1e-5 relative), and such frames are counted (none on these streams).

Configurations: aligned IoU, Mahalanobis, oriented IoU and Mahalanobis,
spatio-temporal constraints, on streams that churn a third of the objects.
"""

import dataclasses

import numpy as np
import pytest
import torch

from similari_tpu import native
from similari_tpu.trackers import host_geometry as jgeo
from similari_tpu.trackers import host_sort as jhost
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu_torch.trackers import host_geometry as pgeo
from similari_tpu_torch.trackers import host_sort as phost
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_step
from similari_tpu_torch.trackers.state import new_sort_state

from torch_parity import (ATOL, RTOL, churn_stream, jax_state_dict,
                          one_cpu_thread, random_boxes, solutions_tie)

one_cpu_thread()

CONFIGS = {
    "aligned_iou": dict(method="iou", oriented=False),
    "maha": dict(method="maha", oriented=False),
    "oriented_iou": dict(method="iou", oriented=True),
    "oriented_maha": dict(method="maha", oriented=True),
    "constraints": dict(method="iou", oriented=False,
                        constraints=((1, 1.0), (3, 2.0))),
    "iou_threshold": dict(method="iou", oriented=True, iou_threshold=0.15,
                          min_confidence=0.3),
}
CAPACITY, HISTORY = 64, 2


def _kw(name):
    return dict(CONFIGS[name], max_idle_epochs=3)


def _frames(name, seed):
    angle = 1.2 if CONFIGS[name]["oriented"] else 0.0
    return churn_stream(seed, steps=10, n=20, spread=600.0, churn=3,
                        angle=angle)


def _leaves(state):
    """Every field of a numpy-leaf state as a dict (the `kf` nested)."""
    return jax_state_dict(state)


def _assert_bit_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "kf":
            for n in a["kf"]:
                np.testing.assert_array_equal(b["kf"][n], a["kf"][n],
                                              err_msg=f"kf.{n}")
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _assert_close(a: dict, b: dict):
    for k in a:
        if k == "kf":
            for n in a["kf"]:
                np.testing.assert_allclose(b["kf"][n], a["kf"][n], rtol=RTOL,
                                           atol=ATOL, err_msg=f"kf.{n}")
        elif a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# --------------------------------------------------------------------------
# host_geometry
# --------------------------------------------------------------------------

def _geometry_pairs():
    rng = np.random.default_rng(4)
    det = random_boxes(rng, 40, spread=150.0)
    trk = random_boxes(rng, 30, spread=150.0)
    trk[:5] = det[:5]  # identical boxes: the collinear tie pass
    trk[5:8, 2] = 0.0
    det[5:8, 2] = 0.0  # aligned boxes among rotated ones
    return det, trk


def test_host_geometry_is_bit_equal_to_jax():
    det, trk = _geometry_pairs()
    np.testing.assert_array_equal(pgeo.box_vertices_np(det),
                                  jgeo.box_vertices_np(det))
    for fn in ("rotated_intersection_np",):
        np.testing.assert_array_equal(
            getattr(pgeo, fn)(det[:, None], trk[None]),
            getattr(jgeo, fn)(det[:, None], trk[None]))
    iou_p, valid_p = pgeo.rotated_iou_matrix_np(det, trk)
    iou_j, valid_j = jgeo.rotated_iou_matrix_np(det, trk)
    np.testing.assert_array_equal(iou_p, iou_j)
    np.testing.assert_array_equal(valid_p, valid_j)
    assert valid_p.sum() > 10 and (iou_p[np.arange(5), np.arange(5)] > 0.99
                                   ).all()


@pytest.mark.parametrize("seed", range(4))
def test_solve_components_is_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    d, c = 14, 18
    w = np.where(rng.uniform(size=(d, c)) < 0.2,
                 rng.integers(1, 5, (d, c)) / 4.0, 0.0).astype(np.float32)
    for theta in (0.3, 0.5):
        np.testing.assert_array_equal(phost._solve_components(w, theta),
                                      jhost._solve_components(w, theta))


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def _run_host(step, cfg, state, frames):
    outs = []
    for e, (box, conf) in enumerate(frames, start=1):
        state, out = step(cfg, state, box, conf, e)
        outs.append({k: np.array(v) for k, v in out.items()})
        yield state, outs[-1]


def _pairs(name, seed, pstep=phost.host_sort_step,
           jstep=jhost.host_sort_step):
    """The frames and two runs over them: the JAX package's `jstep` (on
    its config and state) and the port's `pstep`, or, with `jstep=None`,
    the port's NumPy twin."""
    frames = _frames(name, seed)
    if jstep is None:
        jcfg, jstep = SortConfig(**_kw(name)), phost.host_sort_step_numpy
        jstate = phost.state_to_host(new_sort_state(CAPACITY, HISTORY,
                                                    device="cpu"))
    else:
        jcfg = JaxSortConfig(**_kw(name))
        jstate = jhost.state_to_host(jax_new_sort_state(CAPACITY, HISTORY))
    pstate = phost.state_to_host(new_sort_state(CAPACITY, HISTORY,
                                                device="cpu"))
    return (frames, _run_host(jstep, jcfg, jstate, frames),
            _run_host(pstep, SortConfig(**_kw(name)), pstate, frames))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_step_is_bit_equal_to_jax_numpy_path(name, monkeypatch):
    monkeypatch.setattr(native, "sort_step_available", lambda: False)
    frames, jrun, prun = _pairs(name, 0, pstep=phost.host_sort_step_numpy)
    for s, ((sj, oj), (sp, op)) in enumerate(zip(jrun, prun)):
        assert oj.keys() == op.keys()
        for k in oj:
            np.testing.assert_array_equal(op[k], oj[k], err_msg=f"{k} {s}")
        _assert_bit_equal(_leaves(sj), _leaves(sp))
    assert int(sp.next_id) > 20 and not op["is_new"].all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_step_matches_jax_native_step(name):
    """The port's C++ step and the JAX package's, built from the same
    code with the same compiler and flags: bit-equal."""
    if not native.sort_step_available():
        pytest.skip("the JAX package's native step did not build")
    frames, jrun, prun = _pairs(name, 1)
    for s, ((sj, oj), (sp, op)) in enumerate(zip(jrun, prun)):
        assert oj.keys() == op.keys()
        for k in oj:
            np.testing.assert_array_equal(op[k], oj[k], err_msg=f"{k} {s}")
        _assert_bit_equal(_leaves(sj), _leaves(sp))
    assert int(sp.next_id) > 20 and not op["is_new"].all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_native_step_matches_its_numpy_twin(name):
    frames, nrun, prun = _pairs(name, 3, jstep=None)
    for s, ((sn, on), (sp, op)) in enumerate(zip(nrun, prun)):
        for k in ("slot", "track_id", "is_new", "length"):
            np.testing.assert_array_equal(op[k], on[k], err_msg=f"{k} {s}")
        np.testing.assert_allclose(op["pred_box"], on["pred_box"], rtol=RTOL,
                                   atol=ATOL)
        _assert_close(_leaves(sn), _leaves(sp))
    assert int(sp.next_id) > 20 and not op["is_new"].all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_step_matches_the_device_step_on_the_cpu(name):
    """Ids as the port's `sort_step` (scipy's exact Hungarian on the CPU)
    gives them; a differing frame must tie in the LP and re-seeds the
    device state from the host one."""
    cfg = SortConfig(**_kw(name))
    frames = _frames(name, 2)
    host = phost.state_to_host(new_sort_state(CAPACITY, HISTORY,
                                              device="cpu"))
    dev = new_sort_state(CAPACITY, HISTORY, device="cpu")
    ties = 0
    for e, (box, conf) in enumerate(frames, start=1):
        before = phost.state_to_host(phost.as_tensors(host))
        host, oh = phost.host_sort_step(cfg, host, box, conf, e)
        n = len(box)
        dev, od = sort_step(cfg, dev, torch.tensor(box), torch.tensor(conf),
                            torch.ones(n, dtype=torch.bool), e)
        ids = od.track_id.numpy()
        if not np.array_equal(ids, oh["track_id"]):
            assert solutions_tie(
                cfg, before, box, conf, e, np.ones(n, bool),
                (oh["slot"], oh["is_new"]),
                (od.slot.numpy(), od.is_new.numpy())), f"frame {e}"
            ties += 1
            dev = phost.state_to_device(host, "cpu")
            continue
        np.testing.assert_array_equal(od.slot.numpy(), oh["slot"])
        np.testing.assert_array_equal(od.length.numpy(), oh["length"])
        np.testing.assert_allclose(od.pred_box.numpy(), oh["pred_box"],
                                   rtol=RTOL, atol=ATOL)
    assert ties == 0
    _assert_close(_leaves(phost.state_to_host(dev)), _leaves(host))


def test_state_moves_between_numpy_and_tensors():
    st = new_sort_state(4, 2, device="cpu")
    st.track_id[1] = 7
    host = phost.state_to_host(st)
    assert isinstance(host.kf.cpp, np.ndarray) and host.next_id.shape == ()
    assert host.track_id.flags.c_contiguous and host.track_id[1] == 7
    grown = phost.host_grow(host, 8)
    assert grown.capacity == 8 and grown.history == 2
    assert grown.track_id.tolist() == [0, 7, 0, 0, 0, 0, 0, 0]
    back = phost.state_to_device(grown, "cpu")
    assert isinstance(back.active, torch.Tensor)
    assert back.track_id.dtype == torch.int32 and back.active.dtype == torch.bool
    assert back.track_id.tolist() == grown.track_id.tolist()
    back.track_id[0] = 3  # a copy: the numpy leaves do not change
    assert grown.track_id[0] == 0
    view = phost.as_tensors(grown)
    view.active.index_fill_(0, torch.tensor([2]), True)  # shares memory
    assert grown.active[2]
    assert dataclasses.replace(grown, next_id=np.int32(5)).next_id == 5


def test_solutions_tie_accepts_only_equal_lp_totals():
    """Two tracks on one spot and two detections there: either matching
    ties; leaving a detection to a new track does not."""
    host = phost.state_to_host(new_sort_state(4, 1, device="cpu"))
    box = np.array([[50.0, 50.0, 0.0, 0.5, 30.0]] * 2, np.float32)
    host.active[:2] = True
    host.pred_box[:2] = box
    host.kf.mean_pos[:2] = box
    cfg = SortConfig(method="iou", oriented=False)
    rows, conf = np.ones(2, bool), np.ones(2, np.float32)
    straight = (np.array([0, 1]), np.zeros(2, bool))
    crossed = (np.array([1, 0]), np.zeros(2, bool))
    one_new = (np.array([0, 2]), np.array([False, True]))
    assert solutions_tie(cfg, host, box, conf, 1, rows, straight, crossed)
    assert not solutions_tie(cfg, host, box, conf, 1, rows, straight, one_new)
