"""The port's host VisualSORT step (`trackers/host_visual.py`) against the
JAX package's, on the CPU.

* The port's NumPy twin (`host_visual_step_numpy`) against the JAX
  module's NumPy path (its native step switched off with monkeypatch):
  outputs (ids, slots, is_new, lengths, voting types) and states
  bit-equal, frame by frame.
* The port's step (`host_visual_step`: its C++ step `csrc/visualstep.cpp`
  on these frames of at most 128 detections) against the JAX module's
  default, native C++ step: outputs and states bit-equal.
* The port's C++ step against its NumPy twin: ids, slots, is_new, lengths
  and voting types equal, states at torch_parity.RTOL/ATOL (the gallery at
  GALLERY_TOL).
* Against the port's own device step on the CPU (`visual_step`, scipy's
  exact Hungarian): ids and voting types equal; a frame whose solutions
  differ is accepted only if the visual winners agree and the positional
  LP totals tie within torch_parity.LP_TIE_RTOL (1e-5 relative), and such
  frames are counted (none on these streams).

Configurations: aligned IoU + euclidean, Mahalanobis + cosine with quality
gates and two votes, constraints, oriented IoU, own-area gates (the f64
clipping oracle's shares), all with missing features on some rows.
"""

import numpy as np
import pytest
import torch

from similari_tpu import native
from similari_tpu.trackers import host_sort as jhost
from similari_tpu.trackers import host_visual as jvis
from similari_tpu.trackers.visual_state import new_visual_state as jax_new_vs
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.trackers import host_sort as phost
from similari_tpu_torch.trackers import host_visual as pvis
from similari_tpu_torch.trackers.visual import own_area_shares_host
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import (VT_VISUAL, VisualConfig,
                                                     visual_step)

from torch_parity import (ATOL, GALLERY_TOL, RTOL, jax_state_dict,
                          one_cpu_thread, solutions_tie)

one_cpu_thread()

BASE = dict(assignment="hungarian", max_idle_epochs=5)
CONFIGS = {
    "euclid_iou": dict(positional_kind="iou", oriented=False,
                       visual_kind="euclidean", visual_threshold=5.0,
                       visual_minimal_track_length=2),
    "cosine_maha_gates": dict(
        positional_kind="maha", oriented=False, visual_kind="cosine",
        visual_threshold=0.6, visual_minimal_track_length=1,
        visual_min_votes=2, visual_minimal_quality_use=0.4,
        visual_minimal_quality_collect=0.5, max_idle_epochs=4),
    "constraints": dict(positional_kind="iou", oriented=False,
                        visual_kind="euclidean", visual_threshold=4.0,
                        visual_minimal_track_length=2,
                        constraints=((1, 1.5), (4, 3.0))),
    "oriented_iou": dict(positional_kind="iou", oriented=True,
                         visual_kind="euclidean", visual_threshold=5.0,
                         visual_minimal_track_length=2),
    "own_area": dict(positional_kind="iou", oriented=False,
                     visual_kind="euclidean", visual_threshold=5.0,
                     visual_minimal_track_length=1, own_area_use=0.6,
                     own_area_collect=0.8, own_area_backend="host"),
}
T, H, K, F = 48, 2, 3, 16


def _kw(name):
    return dict(BASE, **CONFIGS[name])


def _frames(name, seed, steps=10, d=10, drop=0.2):
    """Random-walk objects with identities plus noise; a fifth of the
    objects missing from each later frame, features missing on ~15% of
    the rows; crowded enough for own-area shares below 1."""
    oriented = CONFIGS[name]["oriented"]
    rng = np.random.default_rng(seed)
    spread = 120.0 if name == "own_area" else 350.0
    xy = rng.uniform(0, spread, (d, 2)).astype(np.float32)
    ang = rng.uniform(0, 1.0, d).astype(np.float32) if oriented else None
    ident = rng.normal(size=(d, F)).astype(np.float32)
    frames = []
    for s in range(steps):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        keep = rng.uniform(size=d) >= (drop if s else 0.0)
        idx = np.flatnonzero(keep)
        n = len(idx)
        box = np.zeros((n, 5), np.float32)
        box[:, :2] = xy[idx]
        if oriented:
            box[:, 2] = ang[idx]
        box[:, 3] = 0.8
        box[:, 4] = 28.0
        feat = (ident[idx] + 0.04 * rng.normal(size=(n, F))).astype(
            np.float32)
        fvalid = rng.uniform(size=n) > 0.15
        conf = rng.uniform(0.5, 1.0, n).astype(np.float32)
        qual = rng.uniform(0.3, 1.0, n).astype(np.float32)
        oa = (own_area_shares_host(box, conf) if name == "own_area"
              else np.ones((n,), np.float32))
        frames.append((box, conf, feat, fvalid, qual, oa))
    return frames


def _run(step, cfg, state, frames):
    for e, fr in enumerate(frames, start=1):
        state, out = step(cfg, state, *fr, e)
        yield state, {k: np.array(v) for k, v in out.items()}


def _pairs(name, seed, pstep=pvis.host_visual_step,
           jstep=jvis.host_visual_step):
    """The frames and two runs over them: the JAX package's `jstep` and
    the port's `pstep`, or, with `jstep=None`, the port's NumPy twin."""
    frames = _frames(name, seed)
    if jstep is None:
        jcfg, jstep = VisualConfig(**_kw(name)), pvis.host_visual_step_numpy
        jstate = phost.state_to_host(new_visual_state(T, H, K, F,
                                                      device="cpu"))
    else:
        jcfg = JaxVisualConfig(**_kw(name))
        jstate = jhost.state_to_host(jax_new_vs(T, H, K, F))
    pstate = phost.state_to_host(new_visual_state(T, H, K, F, device="cpu"))
    return (frames, _run(jstep, jcfg, jstate, frames),
            _run(pstep, VisualConfig(**_kw(name)), pstate, frames))


def _compare_states(a: dict, b: dict, exact: bool):
    for k in a:
        if k == "kf":
            for n in a["kf"]:
                if exact:
                    np.testing.assert_array_equal(b["kf"][n], a["kf"][n])
                else:
                    np.testing.assert_allclose(b["kf"][n], a["kf"][n],
                                               rtol=RTOL, atol=ATOL)
        elif exact or a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            tol = GALLERY_TOL if k in ("feats", "hist_feat") else RTOL
            np.testing.assert_allclose(b[k], a[k], rtol=tol,
                                       atol=GALLERY_TOL if tol == GALLERY_TOL
                                       else ATOL, err_msg=k)


OUT_EXACT = ("slot", "track_id", "is_new", "length", "voting_type")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_visual_step_is_bit_equal_to_jax_numpy_path(name, monkeypatch):
    monkeypatch.setattr(native, "visual_step_available", lambda: False)
    frames, jrun, prun = _pairs(name, 0, pstep=pvis.host_visual_step_numpy)
    vts = []
    for s, ((sj, oj), (sp, op)) in enumerate(zip(jrun, prun)):
        assert oj.keys() == op.keys()
        for k in oj:
            np.testing.assert_array_equal(op[k], oj[k], err_msg=f"{k} {s}")
        _compare_states(jax_state_dict(sj), jax_state_dict(sp), exact=True)
        vts.append(op["voting_type"][~op["is_new"]])
    vts = np.concatenate(vts)
    assert (vts == VT_VISUAL).any() and (vts != VT_VISUAL).any()
    if name == "own_area":
        assert min(fr[5].min() for fr in frames) < 0.6


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_visual_step_matches_jax_native_step(name):
    """The port's C++ step and the JAX package's, built from the same
    code with the same compiler and flags: bit-equal."""
    if not native.visual_step_available():
        pytest.skip("the JAX package's native step did not build")
    frames, jrun, prun = _pairs(name, 1)
    for s, ((sj, oj), (sp, op)) in enumerate(zip(jrun, prun)):
        assert oj.keys() == op.keys()
        for k in oj:
            np.testing.assert_array_equal(op[k], oj[k], err_msg=f"{k} {s}")
        _compare_states(jax_state_dict(sj), jax_state_dict(sp), exact=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_native_visual_step_matches_its_numpy_twin(name):
    frames, nrun, prun = _pairs(name, 3, jstep=None)
    vts = []
    for s, ((sn, on), (sp, op)) in enumerate(zip(nrun, prun)):
        for k in OUT_EXACT:
            np.testing.assert_array_equal(op[k], on[k], err_msg=f"{k} {s}")
        np.testing.assert_allclose(op["pred_box"], on["pred_box"], rtol=RTOL,
                                   atol=ATOL)
        _compare_states(jax_state_dict(sn), jax_state_dict(sp), exact=False)
        vts.append(op["voting_type"][~op["is_new"]])
    vts = np.concatenate(vts)
    assert (vts == VT_VISUAL).any() and (vts != VT_VISUAL).any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_visual_step_matches_the_device_step_on_the_cpu(name):
    cfg = VisualConfig(**_kw(name))
    host = phost.state_to_host(new_visual_state(T, H, K, F, device="cpu"))
    dev = new_visual_state(T, H, K, F, device="cpu")
    ties = 0
    for e, fr in enumerate(_frames(name, 2), start=1):
        before = phost.state_to_host(phost.as_tensors(host))
        host, oh = pvis.host_visual_step(cfg, host, *fr, e)
        box, conf, feat, fvalid, qual, oa = map(torch.tensor, fr)
        n = len(box)
        dev, od = visual_step(cfg, dev, box, conf,
                              torch.ones(n, dtype=torch.bool), feat, fvalid,
                              qual, oa, e)
        if not np.array_equal(od.track_id.numpy(), oh["track_id"]):
            visual_h = oh["voting_type"] == VT_VISUAL
            visual_d = od.voting_type.numpy() == VT_VISUAL
            np.testing.assert_array_equal(visual_d, visual_h)
            assert solutions_tie(
                cfg, before, fr[0], fr[1], e, ~visual_h,
                (oh["slot"], oh["is_new"]),
                (od.slot.numpy(), od.is_new.numpy())), f"frame {e}"
            ties += 1
            dev = phost.state_to_device(host, "cpu")
            continue
        for k in OUT_EXACT:
            np.testing.assert_array_equal(getattr(od, k).numpy(), oh[k],
                                          err_msg=f"{k} {e}")
    assert ties == 0
    _compare_states(jax_state_dict(host),
                    jax_state_dict(phost.state_to_host(dev)), exact=False)
