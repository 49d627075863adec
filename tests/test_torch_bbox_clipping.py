"""The port's box types, f64 polygon clipping and `nms()` against the JAX
package, on the CPU.

The clipping oracle is the same f64 arithmetic in both packages: areas,
vertices and own-area shares are held at 1e-9.  `nms()` keeps must be
equal (the port runs every frame through `ops/nms.py::nms_kernel`; the
JAX package sends small frames to its host loop, with the same keeps).
"""

import math

import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu_torch.ops import clip as pclip
from similari_tpu_torch.ops import nms as pnms
from similari_tpu_torch.utils.bbox import boxes_to_tensor, normalize_angle

from torch_parity import one_cpu_thread, random_boxes

one_cpu_thread()

TOL = 1e-9


def _pair(pkg, ltwh_or_box):
    """The same box in one package: ("ltwh", l, t, w, h) or a vec5 row."""
    if ltwh_or_box[0] == "ltwh":
        return pkg.BoundingBox(*ltwh_or_box[1:]).as_xyaah()
    xc, yc, ang, asp, h = ltwh_or_box
    return pkg.Universal2DBox(xc, yc, ang, asp, h)


# the cases of tests/test_nms_clipping.py and tests/test_regressions.py
CLIP_CASES = {
    "aligned_cross": (("ltwh", 0.0, 0.0, 5.0, 10.0),
                      ("ltwh", 0.0, 0.0, 10.0, 5.0)),
    "rotated_0.5": (("ltwh", 0.0, 0.0, 5.0, 10.0),
                    (2.5, 5.0, 0.5, 0.5, 10.0)),
    "equal_angle_0.9": ((0.0, 0.0, 0.9, 1.0, 4.0), (1.0, 0.5, 0.9, 1.0, 4.0)),
    "equal_angle_pi/2": ((0.0, 0.0, math.pi / 2, 1.0, 4.0),
                         (1.0, 0.5, math.pi / 2, 1.0, 4.0)),
    "octagon": ((0.0, 0.0, None, 1.0, 2.0), (0.0, 0.0, math.pi / 4, 1.0, 2.0)),
    "disjoint": ((0.0, 0.0, 0.3, 1.0, 4.0), (50.0, 0.0, 0.3, 1.0, 4.0)),
}


@pytest.mark.parametrize("name", sorted(CLIP_CASES))
def test_clip_and_intersection_match_jax(name):
    a_spec, b_spec = CLIP_CASES[name]
    pj = jx.sutherland_hodgman_clip(_pair(jx, a_spec), _pair(jx, b_spec))
    pp = pt.sutherland_hodgman_clip(_pair(pt, a_spec), _pair(pt, b_spec))
    assert isinstance(pp, pt.Polygon) and len(pp) == len(pj)
    np.testing.assert_allclose(np.array(pp.get_points()).reshape(-1, 2),
                               np.array(pj.get_points()).reshape(-1, 2),
                               rtol=0, atol=TOL)
    area = pt.intersection_area(_pair(pt, a_spec), _pair(pt, b_spec))
    assert area == pytest.approx(
        jx.intersection_area(_pair(jx, a_spec), _pair(jx, b_spec)), abs=TOL)
    assert area == pytest.approx(pp.area(), abs=TOL)


def test_golden_areas():
    """The 45-degree octagon (8(sqrt 2 - 1)), the aligned cross (25) and
    the reference's own-area goldens (`bbox_own_areas.rs:57-79`)."""
    sq = pt.Universal2DBox(0.0, 0.0, None, 1.0, 2.0)
    rot = pt.Universal2DBox(0.0, 0.0, None, 1.0, 2.0).rotate(math.pi / 4)
    assert pt.intersection_area(sq, rot) == pytest.approx(
        8 * (math.sqrt(2) - 1), abs=TOL)
    cross = [pt.BoundingBox(0.0, 0.0, 5.0, 10.0).as_xyaah(),
             pt.BoundingBox(0.0, 0.0, 10.0, 5.0).as_xyaah()]
    assert pt.intersection_area(*cross) == pytest.approx(25.0, abs=TOL)
    boxes = [pt.BoundingBox(x, x, 10.0, 10.0).as_xyaah()
             for x in (0.0, 5.0, 10.0)]
    own = pt.exclusively_owned_areas(boxes)
    assert own == pytest.approx([75.0, 50.0, 75.0], abs=TOL)
    assert pt.exclusively_owned_areas_normalized_shares(
        boxes, own) == pytest.approx([0.75, 0.5, 0.75], abs=1e-6)
    triple = [pt.BoundingBox(x, y, 10.0, 10.0).as_xyaah()
              for x, y in ((0.0, 0.0), (5.0, 0.0), (0.0, 5.0))]
    assert pt.exclusively_owned_areas(triple)[0] == pytest.approx(25.0,
                                                                  abs=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_own_areas_match_jax_on_crowds(seed):
    """Rotated, overlapping boxes: inclusion-exclusion of depth > 2."""
    b = random_boxes(np.random.default_rng(seed), 24, spread=120.0)
    jb = [jx.Universal2DBox(*map(float, r)) for r in b]
    pb = [pt.Universal2DBox(*map(float, r)) for r in b]
    own_j = jx.exclusively_owned_areas(jb)
    own_p = pt.exclusively_owned_areas(pb)
    assert min(own_p) < max(b[:, 3] * b[:, 4] ** 2)  # some box is covered
    np.testing.assert_allclose(own_p, own_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        pt.exclusively_owned_areas_normalized_shares(pb),
        jx.exclusively_owned_areas_normalized_shares(jb), rtol=0, atol=TOL)


def test_box_types_match_jax():
    ltwh = (10.0, 11.0, 3.0, 3.8)
    bj, bp = jx.BoundingBox(*ltwh), pt.BoundingBox(*ltwh)
    uj, up = bj.as_xyaah(), bp.as_xyaah()
    assert (up.xc, up.yc, up.aspect, up.height) == (uj.xc, uj.yc, uj.aspect,
                                                    uj.height)
    assert up.as_ltwh() == bp and bp.iou(pt.BoundingBox(10.5, 11, 3, 3.8)) \
        == bj.iou(jx.BoundingBox(10.5, 11, 3, 3.8))
    up.rotate(0.3)
    with pytest.raises(pt.GenericBBoxConversionError):
        up.as_ltwh()
    assert up.get_vertices().get_points() == uj.rotate(0.3).get_vertices() \
        .get_points()
    assert up.get_radius() == uj.get_radius() and up.area() == uj.area()
    with pytest.raises(ValueError):
        pt.Universal2DBox.new_with_confidence(0, 0, None, 1, 1, 1.5)
    for a in (-7.0, -0.1, 0.0, 3.0, 13.0):
        assert normalize_angle(a) == jx.utils.bbox.normalize_angle(a)
    boxes = [pt.Universal2DBox.new_with_confidence(1, 2, None, 0.5, 10, 0.7),
             up]
    t, conf = boxes_to_tensor(boxes)
    np.testing.assert_array_equal(t[1], up.to_vec5())
    np.testing.assert_allclose(conf, [0.7, 1.0])
    back = pt.Universal2DBox.from_vec5(t[1], 0.25)
    assert back == up and back.confidence == 0.25


def _nms_inputs(seed, n, oriented, scored):
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, 10 * math.sqrt(n), n)
    b[:, 1] = rng.uniform(0, 10 * math.sqrt(n), n)
    b[:, 2] = rng.uniform(0, 0.9, n) if oriented else 0.0
    b[:, 3] = rng.uniform(0.5, 1.5, n)
    b[:, 4] = rng.uniform(15, 45, n)
    scores = rng.uniform(0.2, 1.0, n) if scored else [None] * n
    return b, scores


def _nms_both(b, scores, thr, score_thr):
    def dets(pkg):
        return [(pkg.Universal2DBox(*(None if j == 2 and v == 0 else float(v)
                                      for j, v in enumerate(r))),
                 None if s is None else float(s))
                for r, s in zip(b, scores)]

    kept_j = jx.nms(dets(jx), thr, score_thr)
    kept_p = pt.nms(dets(pt), thr, score_thr, device="cpu")
    return ([k.to_vec5().tolist() for k in kept_j],
            [k.to_vec5().tolist() for k in kept_p])


@pytest.mark.parametrize("n", [10, 200])
@pytest.mark.parametrize("oriented", [False, True])
@pytest.mark.parametrize("scored", [False, True])
def test_nms_matches_jax(n, oriented, scored):
    b, scores = _nms_inputs(n + oriented, n, oriented, scored)
    kept_j, kept_p = _nms_both(b, scores, 0.3, 0.3 if scored else None)
    assert 0 < len(kept_p) < n
    assert kept_p == kept_j


def test_nms_block_skip_route_matches_jax(monkeypatch):
    """The block-skip route, the one CUDA takes for oriented frames of 512
    boxes or more, run here through the clip kernel's plain version."""
    calls = []
    orig = pclip.clip_pairs

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pclip, "clip_pairs", counting)
    monkeypatch.setattr(pnms, "use_block_skip", lambda *a: True)
    b, scores = _nms_inputs(5, 600, True, True)
    kept_j, kept_p = _nms_both(b, scores, 0.2, None)
    assert calls == [1] and kept_p == kept_j


def test_nms_api_edges():
    assert pt.nms([], 0.5, device="cpu") == []
    flat = pt.Universal2DBox(0, 0, None, 1.0, 0.0)
    assert pt.nms([(flat, 0.9)], 0.5, device="cpu") == []
    keep = pt.nms([(pt.BoundingBox(10.3, 11.1, 2.9, 3.9).as_xyaah(), 0.9),
                   (pt.BoundingBox(10.0, 11.0, 3.0, 3.8).as_xyaah(), 1.0)],
                  0.7, 0.0, device="cpu")
    assert len(keep) == 1 and keep[0].as_ltwh() == pt.BoundingBox(
        10.0, 11.0, 3.0, 3.8)


def test_nms_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.nms([(pt.Universal2DBox(0, 0, None, 1, 5), None)], 0.5)
