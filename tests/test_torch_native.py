"""The port's host C++ runtime (`similari_tpu_torch/native.py` over
`csrc/`) against the JAX package's (`similari_tpu.native`), both built in
this process from the same code with the same compiler and flags, on the
CPU.

* The sources: the port's code lines (comments and blank lines aside) are
  the JAX package's.
* Bit-equal (`array_equal`), frame by frame: the SORT step as a function
  and as a session (outputs, next ids, every state leaf) on the
  configurations of tests/test_torch_host_sort.py; the VisualSORT step
  likewise on those of tests/test_torch_host_visual.py and on larger
  stores whose frames cross `_DMAT_MIN_MADDS`, the BLAS product's
  threshold; the Kalman sequences ([N, 5], [N, 2], [N, P, 2]); the rotated
  IoU; NMS and batched NMS; the MOT loader on 7-column, 6-column,
  header-line and frame-gap files.
* The loader equals its plain version (`_load_sequence_soa_numpy`).
* Shape errors raise ValueError; a leaf of the wrong layout too.
* No fallback: with no compiler and nothing built, the library and the
  entry points on it raise RuntimeError naming the compiler.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import similari_tpu_torch as pt
from similari_tpu import native as jn
from similari_tpu.trackers import host_sort as jhost
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu.trackers.visual_state import new_visual_state as jax_new_vs
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch import _build
from similari_tpu_torch import native as pn
from similari_tpu_torch.trackers import host_sort as phost
from similari_tpu_torch.trackers.sort_step import SortConfig
from similari_tpu_torch.trackers.state import new_sort_state
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import VisualConfig

import test_torch_host_sort as hs
import test_torch_host_visual as hv
from torch_parity import (churn_stream, jax_state_dict, one_cpu_thread,
                          random_boxes, write_mot_det)

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
SOURCES = _build.HOST_SOURCES + _build.HOST_HEADERS


def _code(path: Path):
    """The lines of a C++ source without comments and blank lines."""
    lines = (re.sub(r"//.*$", "", line).rstrip()
             for line in path.read_text().splitlines())
    return [line for line in lines if line]


@pytest.mark.parametrize("name", SOURCES)
def test_sources_are_the_jax_packages_code(name):
    ours = _code(_build.CSRC / name)
    assert ours == _code(ROOT / "similari_tpu" / "native" / name)
    assert len(ours) > 50


def _assert_leaves_equal(a, b):
    da, db = jax_state_dict(a), jax_state_dict(b)
    assert da.keys() == db.keys()
    for k in da:
        if k == "kf":
            for n in da["kf"]:
                np.testing.assert_array_equal(db["kf"][n], da["kf"][n],
                                              err_msg=f"kf.{n}")
        elif k != "next_id":  # the steps return the counter, not store it
            np.testing.assert_array_equal(db[k], da[k], err_msg=k)


def _assert_outputs_equal(oj, op, s):
    assert len(oj) == len(op)
    for i, (a, b) in enumerate(zip(oj, op)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"output {i} frame {s}")


# --------------------------------------------------------------------------
# SORT step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("api", ["function", "session"])
@pytest.mark.parametrize("name", sorted(hs.CONFIGS))
def test_sort_step_is_bit_equal(name, api):
    kw = hs._kw(name)
    jcfg, pcfg = JaxSortConfig(**kw), SortConfig(**kw)
    jst = jhost.state_to_host(jax_new_sort_state(hs.CAPACITY, hs.HISTORY))
    pst = phost.state_to_host(new_sort_state(hs.CAPACITY, hs.HISTORY,
                                             device="cpu"))
    if api == "session":
        js, ps = jn.SortStepSession(jcfg, jst), pn.SortStepSession(pcfg, pst)
    nid = 0
    for e, (box, conf) in enumerate(hs._frames(name, 5), start=1):
        if api == "session":
            oj = js.step(box, conf, e, nid)
            op = ps.step(box, conf, e, nid)
        else:
            jst.next_id[...] = pst.next_id[...] = nid
            oj = jn.sort_step_host(jcfg, jst, box, conf, e)
            op = pn.sort_step_host(pcfg, pst, box, conf, e)
        _assert_outputs_equal(oj, op, e)
        _assert_leaves_equal(jst, pst)
        nid = op[0]
    assert nid > 20 and not op[3].all()


# --------------------------------------------------------------------------
# VisualSORT step
# --------------------------------------------------------------------------

# stores big enough that a frame's gallery product crosses
# `_DMAT_MIN_MADDS` (100 x 100 tracks x 4 lanes x 64 > 2e6) after the first
# frames, which stay below it
SGEMM = {"euclid_iou": (dict(hv.CONFIGS["euclid_iou"]), 100),
         "cosine_maha_gates": (dict(hv.CONFIGS["cosine_maha_gates"]), 100)}
BIG = dict(T=256, H=2, K=4, F=64)


def _visual_frames(seed, steps, d, f):
    rng = np.random.default_rng(seed)
    ident = rng.normal(size=(d, f)).astype(np.float32)
    out = []
    for boxes, conf in churn_stream(seed, steps, d, spread=900.0, churn=3):
        feat = (ident + 0.05 * rng.normal(size=(d, f))).astype(np.float32)
        fvalid = rng.uniform(size=d) > 0.15
        qual = rng.uniform(0.3, 1.0, d).astype(np.float32)
        out.append((boxes, conf, feat, fvalid, qual,
                    np.ones((d,), np.float32)))
    return out


def _visual_case(case):
    """(config kwargs, frames, (T, H, K, F))."""
    if case in hv.CONFIGS:
        return (hv._kw(case), hv._frames(case, 5),
                (hv.T, hv.H, hv.K, hv.F))
    kw, d = SGEMM[case.split(":")[1]]
    return (dict(hv.BASE, **kw), _visual_frames(6, 6, d, BIG["F"]),
            tuple(BIG.values()))


@pytest.mark.parametrize("api", ["function", "session"])
@pytest.mark.parametrize("case", sorted(hv.CONFIGS) + [
    f"sgemm:{k}" for k in sorted(SGEMM)])
def test_visual_step_is_bit_equal(case, api, monkeypatch):
    kw, frames, (t, h, k, f) = _visual_case(case)
    products = []  # per frame: did the BLAS product run
    dmat = pn._visual_dmat

    def counted(*args):
        out = dmat(*args)
        products.append(out[0] is not None)
        return out

    monkeypatch.setattr(pn, "_visual_dmat", counted)
    jcfg, pcfg = JaxVisualConfig(**kw), VisualConfig(**kw)
    jst = jhost.state_to_host(jax_new_vs(t, h, k, f))
    pst = phost.state_to_host(new_visual_state(t, h, k, f, device="cpu"))
    if api == "session":
        js = jn.VisualStepSession(jcfg, jst)
        ps = pn.VisualStepSession(pcfg, pst)
    nid = 0
    for e, fr in enumerate(frames, start=1):
        if api == "session":
            oj = js.step(*fr, e, nid)
            op = ps.step(*fr, e, nid)
        else:
            jst.next_id[...] = pst.next_id[...] = nid
            oj = jn.visual_step_host(jcfg, jst, *fr, e)
            op = pn.visual_step_host(pcfg, pst, *fr, e)
        _assert_outputs_equal(oj, op, e)
        _assert_leaves_equal(jst, pst)
        nid = op[0]
    assert (op[6][~op[3]] == 0).any()  # visual votes won
    assert any(products) == case.startswith("sgemm")
    assert not all(products)


def test_visual_step_takes_f32_galleries_only():
    cfg = VisualConfig()
    st = phost.state_to_host(new_visual_state(8, 1, 2, 4, device="cpu"))
    half = dataclasses.replace(st, feats=st.feats.astype(np.float16))
    with pytest.raises(ValueError, match="f32 gallery"):
        pn.VisualStepSession(cfg, half)


def test_a_leaf_of_the_wrong_layout_raises():
    """Row-major f32 or the step would read garbage (a column-major copy
    is what `np.array(x)` can give; state_to_host asks for order="C")."""
    cfg = SortConfig(method="iou", oriented=False)
    st = phost.state_to_host(new_sort_state(8, 2, device="cpu"))
    for bad in (np.zeros((5, 8), np.float32).T,
                st.pred_box.astype(np.float64), st.pred_box[:4]):
        with pytest.raises(ValueError, match="C-contiguous numpy"):
            pn.SortStepSession(cfg, dataclasses.replace(st, pred_box=bad))
    session = pn.SortStepSession(cfg, st)
    box = np.zeros((3, 5), np.float32)
    for det_box, det_conf in ((box[:, :4], np.ones(3)), (box, np.ones(2))):
        with pytest.raises(ValueError, match="expected shape"):
            session.step(det_box, det_conf, 1, 0)


# --------------------------------------------------------------------------
# Kalman sequences, rotated IoU, NMS
# --------------------------------------------------------------------------

def _kf_inputs():
    rng = np.random.default_rng(21)
    box = np.zeros((150, 5), np.float32)
    box[:, :2] = np.cumsum(rng.normal(size=(150, 2)), axis=0)
    box[:, 2] = rng.uniform(-0.1, 0.1, 150)
    box[:, 3] = 0.5 + rng.uniform(0, 0.1, 150)
    box[:, 4] = 30 + np.cumsum(rng.normal(size=150) * 0.2)
    return {"box": box,
            "point": np.cumsum(rng.normal(size=(120, 2)), axis=0).astype(
                np.float32),
            "points": np.cumsum(rng.normal(size=(60, 9, 2)), axis=0).astype(
                np.float32)}


@pytest.mark.parametrize("weights", [(0.05, 0.00625), (0.1, 0.02)])
@pytest.mark.parametrize("kind", ["box", "point", "points"])
def test_kalman_sequences_are_bit_equal(kind, weights):
    z = _kf_inputs()[kind]
    fn = "kf_box_sequence" if kind == "box" else "kf_point_sequence"
    ours = getattr(pn, fn)(z, *weights)
    assert ours.shape == z.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, getattr(jn, fn)(z, *weights))
    assert not np.array_equal(ours, z)


@pytest.mark.parametrize("shape", [(5, 3, 1), (5, 3), (5,), (5, 1)])
def test_point_sequence_rejects_a_last_dimension_other_than_two(shape):
    with pytest.raises(ValueError, match="points must be"):
        pn.kf_point_sequence(np.zeros(shape, np.float32), 0.05, 0.00625)
    with pytest.raises(ValueError, match="must be"):
        pt.Vec2DKalmanFilter().filter_sequence(np.zeros(shape, np.float32))


@pytest.mark.parametrize("shape", [(5, 4), (5, 1, 5), (5,)])
def test_box_sequence_rejects_other_shapes(shape):
    with pytest.raises(ValueError, match="boxes must be"):
        pn.kf_box_sequence(np.zeros(shape, np.float32), 0.05, 0.00625)


def test_rotated_iou_pairs_is_bit_equal():
    rng = np.random.default_rng(22)
    a = random_boxes(rng, 400, spread=120.0)
    b = random_boxes(rng, 400, spread=120.0)
    b[:20] = a[:20]  # identical boxes: IoU exactly 1
    a[20:40, 2] = b[20:40, 2] = 0.0  # aligned pairs
    ours = pn.rotated_iou_pairs(a, b)
    np.testing.assert_array_equal(ours, jn.rotated_iou_pairs(a, b))
    assert (np.abs(ours[:20] - 1.0) < 1e-6).all()
    assert (ours[20:] > 0).sum() > 40


def _nms_frames(oriented, n=48, frames=3):
    rng = np.random.default_rng(23 + oriented)
    out = random_boxes(rng, frames * n, spread=150.0).reshape(frames, n, 5)
    if not oriented:
        out[..., 2] = 0.0
    return out


@pytest.mark.parametrize("threshold", [0.3, 0.6])
@pytest.mark.parametrize("oriented", [False, True])
def test_nms_is_bit_equal(oriented, threshold):
    boxes = _nms_frames(oriented)
    batch = pn.nms_host_batch(boxes, threshold, oriented)
    np.testing.assert_array_equal(
        batch, jn.nms_host_batch(boxes, threshold, oriented))
    for i, frame in enumerate(boxes):
        keep = pn.nms_host(frame, threshold, oriented)
        np.testing.assert_array_equal(keep,
                                      jn.nms_host(frame, threshold, oriented))
        np.testing.assert_array_equal(keep, batch[i])
    assert 0 < batch.sum() < batch.size


# --------------------------------------------------------------------------
# the MOT loader
# --------------------------------------------------------------------------

def _mot_detections(gaps):
    rng = np.random.default_rng(24)
    dets = {}
    for f in range(1, 13):
        if gaps and f % 4 == 0:
            continue  # a frame with no detections
        n = int(rng.integers(1, 11))
        dets[f] = [tuple(np.round(np.r_[rng.uniform(0, 500, 2),
                                        rng.uniform(10, 80, 2),
                                        rng.uniform(0.1, 1.0)], 2))
                   for _ in range(n)]
    return dets


MOT_FILES = {"seven_columns": dict(columns=7),
             "six_columns": dict(columns=6),
             "header_line": dict(columns=7, header=True),
             "frame_gaps": dict(columns=7, gaps=True)}


@pytest.mark.parametrize("name", sorted(MOT_FILES))
def test_load_sequence_soa_is_bit_equal(name, tmp_path):
    kw = dict(MOT_FILES[name])
    path = tmp_path / "det.txt"
    held = write_mot_det(path, _mot_detections(kw.pop("gaps", False)), **kw)
    ours = pn.load_sequence_soa(path)
    for a, b, c in zip(ours, jn.load_sequence_soa(path),
                       pn._load_sequence_soa_numpy(path)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == c.dtype
    frames, box, conf, valid = ours
    assert frames.tolist() == sorted(held)
    assert box.shape[1] == 16 and valid.sum() == sum(map(len, held.values()))
    for s, f in enumerate(frames.tolist()):
        rows = np.asarray(held[f], np.float32)
        np.testing.assert_array_equal(conf[s, :len(rows)], rows[:, 4])


def test_load_sequence_soa_skips_garbage_and_reads_a_missing_file(tmp_path):
    path = tmp_path / "det.txt"
    path.write_text("frame,id,l,t,w,h,conf\n1,-1,10,20,30,40\n\n"
                    "x,y\n2,-1,0,0,8,8,0.25,-1,-1,-1\n1,-1,50,60,20,10,"
                    "0.5\n")
    ours = pn.load_sequence_soa(path)
    for a, b in zip(ours, pn._load_sequence_soa_numpy(path)):
        np.testing.assert_array_equal(a, b)
    frames, box, conf, valid = ours
    assert frames.tolist() == [1, 2] and valid.sum() == 3
    assert conf[0, :2].tolist() == [1.0, 0.5] and conf[1, 0] == 0.25
    np.testing.assert_array_equal(box[0, 0], [25, 40, 0, 0.75, 40])
    with pytest.raises(FileNotFoundError):
        pn.load_sequence_soa(tmp_path / "missing.txt")


# --------------------------------------------------------------------------
# no fallback
# --------------------------------------------------------------------------

def _entry_points():
    box = np.array([[10, 10, 0, 1, 20]], np.float32)
    return {
        "host_library": _build.host_library,
        "sort_host": lambda: pt.Sort(engine="host", device="cpu")
        .predict_arrays(0, box, np.ones(1, np.float32)),
        "visual_host": lambda: pt.VisualSort(engine="host", device="cpu")
        .predict_arrays(0, box, np.ones(1, np.float32)),
        "filter_sequence": lambda: pt.Universal2DBoxKalmanFilter()
        .filter_sequence(np.tile(box, (3, 1))),
        "nms_cpu": lambda: pt.nms([(pt.Universal2DBox(10, 10, None, 1, 20),
                                    0.9)], 0.5, device="cpu"),
        "lap": lambda: pn.lap_max(np.ones((2, 3), np.float32)),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_no_compiler_raises_naming_it(entry, monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_HOST", _build._Library())
    with pytest.raises(RuntimeError, match="/nonexistent/c\\+\\+"):
        _entry_points()[entry]()
    assert not list(tmp_path.glob("*.so"))
