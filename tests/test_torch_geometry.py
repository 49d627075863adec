"""The port's box geometry (ops/geometry.py) against the JAX package's, on
the CPU, plus the goldens of tests/test_geometry.py.

Both packages get the same numpy boxes.  Values are held at 2e-4: the two
keep one operation order, but XLA may contract a multiply-add that
PyTorch rounds twice, and cos/sin may differ in the last bit.  Booleans
(too_far, validity) must be equal away from their thresholds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import geometry as G
from similari_tpu_torch.ops import geometry as PG

from torch_parity import one_cpu_thread, random_boxes

one_cpu_thread()

TOL = 2e-4


def _pairs(seed, n=96):
    """Pairs of boxes: a third far apart, the rest overlapping or near."""
    rng = np.random.default_rng(seed)
    a = random_boxes(rng, n, spread=200.0)
    b = a.copy()
    b[:, :2] += rng.uniform(-40, 40, (n, 2)).astype(np.float32)
    b[:, 2:] = random_boxes(rng, n)[:, 2:]
    b[: n // 3, 0] += 5000.0
    return a, b


def _both(fn_name, *arrays):
    """(JAX result, port result) as numpy, for G.fn and PG.fn."""
    j = getattr(G, fn_name)(*(jnp.asarray(x) for x in arrays))
    p = getattr(PG, fn_name)(*(torch.tensor(x) for x in arrays))
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in p]
    return np.asarray(j), p.numpy()


@pytest.mark.parametrize("fn", ["box_radius", "box_area", "box_vertices"])
@pytest.mark.parametrize("seed", [0, 1])
def test_box_helpers_match_jax(fn, seed):
    a, _ = _pairs(seed)
    j, p = _both(fn, a)
    assert j.shape == p.shape
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_normalize_angle_matches_jax_and_goldens():
    a = np.array([0.3, -0.3, 6.583184, 0.0, 2 * math.pi, -7.5, 100.0],
                 np.float32)
    j, p = _both("normalize_angle", a)
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5)
    assert abs(p[0] - 0.3) < 1e-5 and abs(p[1] - 5.983184) < 1e-5
    assert abs(p[2] - 0.3) < 1e-4


@pytest.mark.parametrize("fn", ["center_distance2", "too_far", "dist_in_2r",
                                "aligned_intersection",
                                "rotated_intersection"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_functions_match_jax(fn, seed):
    a, b = _pairs(seed)
    if fn == "aligned_intersection":
        a[:, 2] = b[:, 2] = 0.0
    j, p = _both(fn, a, b)
    if fn == "too_far":
        np.testing.assert_array_equal(p, j)
        assert p.any() and not p.all()
    else:
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
        if fn == "rotated_intersection":
            assert (p[: len(p) // 3] == 0.0).all()  # far pairs exactly 0
            assert (p > 0).sum() > len(p) // 3


@pytest.mark.parametrize("seed", [0, 1])
def test_quad_intersection_area_matches_jax(seed):
    a, b = _pairs(seed)
    va, vb = G.box_vertices(jnp.asarray(a)), G.box_vertices(jnp.asarray(b))
    j = np.asarray(G.quad_intersection_area(va, vb))
    p = PG.quad_intersection_area(torch.tensor(np.asarray(va)),
                                  torch.tensor(np.asarray(vb))).numpy()
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("oriented", [True, False])
def test_universal_iou_matches_jax(oriented):
    a, b = _pairs(2)
    if not oriented:
        a[:, 2] = b[:, 2] = 0.0
    j = G.universal_iou(jnp.asarray(a), jnp.asarray(b), oriented)
    p = PG.universal_iou(torch.tensor(a), torch.tensor(b), oriented)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]), rtol=TOL,
                               atol=TOL)
    diff = p[1].numpy() != np.asarray(j[1])
    assert (np.asarray(j[0])[diff] < 1e-4).all()


@pytest.mark.parametrize("oriented", [True, False])
def test_universal_iou_matrix_matches_jax(oriented):
    rng = np.random.default_rng(4)
    a = random_boxes(rng, 24, spread=150.0)
    b = random_boxes(rng, 40, spread=150.0)
    if not oriented:
        a[:, 2] = b[:, 2] = 0.0
    j = G.universal_iou_matrix(jnp.asarray(a), jnp.asarray(b), oriented)
    p = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b), oriented)
    assert p[0].shape == (24, 40)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]), rtol=TOL,
                               atol=TOL)
    diff = p[1].numpy() != np.asarray(j[1])
    assert (np.asarray(j[0])[diff] < 1e-4).all()
    assert p[1].any()


def test_topk_neighbors_not_ported():
    """The radius-pruned top-k route (named for when it was missing): 0 <
    neighbors < T takes it, each row keeping its 2 nearest partners, equal
    to JAX's; neighbors >= T and aligned boxes take the dense form, as in
    the JAX package (tests/test_torch_topk.py holds the rest)."""
    rng = np.random.default_rng(4)
    a = random_boxes(rng, 4, spread=40.0)
    b = random_boxes(rng, 8, spread=40.0)
    iou, valid = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b),
                                         True, neighbors=2)
    j = G.universal_iou_matrix(jnp.asarray(a), jnp.asarray(b), True,
                               neighbors=2)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(iou.numpy(), np.asarray(j[0]), rtol=TOL,
                               atol=TOL)
    assert int(valid.sum(1).max()) == 2
    dense = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b), True)
    assert int(dense[1].sum(1).max()) > 2
    for nbrs, oriented in ((8, True), (2, False)):
        got = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b),
                                      oriented, neighbors=nbrs)
        want = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b),
                                       oriented)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _v(*args):
    return torch.tensor(args, dtype=torch.float32)


def test_octagon_golden():
    """A 2x2 square against itself turned 45 degrees: an octagon of area
    8(sqrt(2) - 1)."""
    sq = _v(0.0, 0.0, 0.0, 1.0, 2.0)
    rot = _v(0.0, 0.0, math.pi / 4, 1.0, 2.0)
    inter = float(PG.rotated_intersection(sq, rot))
    assert abs(inter - 8 * (math.sqrt(2) - 1)) < 1e-5
    assert abs(inter - float(G.rotated_intersection(
        jnp.asarray(sq.numpy()), jnp.asarray(rot.numpy())))) < 1e-6


def test_transform_golden():
    b1 = _v(0.0, 0.0, 2.0, 0.5, 2.0)
    b2 = _v(0.0, 0.0, 2.0 + math.pi / 2.0, 0.5, 2.0)
    inter = float(PG.rotated_intersection(b1, b2))
    union = float(PG.box_area(b1) + PG.box_area(b2)) - inter
    assert abs(union - 3.0) < 1e-4
    iou, valid = PG.universal_iou(b1, b2)
    assert bool(valid) and abs(float(iou) - inter / union) < 1e-5
    b3 = _v(10.0, 0.0, 2.0 + math.pi / 2.0, 0.5, 2.0)
    assert float(PG.rotated_intersection(b1, b3)) == 0.0
    assert not bool(PG.universal_iou(b1, b3)[1])


def test_degenerate_configurations():
    """Where the collinear tie-break decides: identical boxes count once,
    touching edges and corners cancel, collinear overlaps are exact."""
    a = _v(0.0, 0.0, 0.0, 1.0, 2.0)
    assert abs(float(PG.rotated_intersection(a, a)) - 4.0) < 1e-5
    r = _v(10.0, -3.0, 0.7, 0.6, 8.0)
    area = float(PG.box_area(r))
    assert abs(float(PG.rotated_intersection(r, r)) - area) < 1e-5 * area
    assert abs(float(PG.universal_iou(r, r)[0]) - 1.0) < 1e-6
    assert float(PG.rotated_intersection(a, _v(2.0, 0.0, 0.0, 1.0, 2.0))) < 1e-5
    assert float(PG.rotated_intersection(a, _v(2.0, 2.0, 0.0, 1.0, 2.0))) < 1e-5
    d = _v(1.0, 0.0, 0.0, 1.0, 2.0)
    assert abs(float(PG.rotated_intersection(a, d)) - 2.0) < 1e-4
    assert float(PG.universal_iou(a, a)[0]) == 1.0


def test_containment_and_large_coordinates():
    big = _v(0.0, 0.0, 0.5, 1.0, 10.0)
    small = _v(0.0, 0.0, 1.2, 1.0, 2.0)
    assert abs(float(PG.rotated_intersection(big, small))
               - float(PG.box_area(small))) < 1e-3
    x = np.array([8044.315, 8011.0454, 2.6787748, 1.00801, 49.8073], np.float32)
    y = np.array([8044.455, 8011.338, 2.6787748, 1.0083783, 49.79979],
                 np.float32)
    j, p = _both("rotated_intersection", x, y)
    assert abs(float(p) - float(j)) <= 1e-4 * float(j)


def test_degenerate_box_iou_is_zero():
    """A zero-area box near a real one must not explode the IoU (the
    `union > 0` guard)."""
    real = torch.tensor([[5.0, 0.0, 0.3, 1.5, 30.0]])
    degen = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0],
                          [2.0, 1.0, 0.5, 2.0, 0.0],
                          [3.0, 0.0, 0.1, 0.0, 25.0]])
    iou, _ = PG.universal_iou_matrix(real, degen, oriented=True)
    assert float(iou.abs().max()) < 1e-6
