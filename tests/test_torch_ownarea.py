"""The port's own-area shares (`ops/ownarea.py`) against the JAX package's
device kernel and the exact host oracle, on the CPU.

Shares are held at 1e-5: both packages clip in the same operation order,
but XLA may contract a multiply-add and sums over neighbours run in
another order.  Against the host f64 oracle the JAX package's own tests
allow 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import geometry as jgeo
from similari_tpu.ops import ownarea as jown
from similari_tpu.utils.bbox import Universal2DBox
from similari_tpu.utils.clipping import (
    exclusively_owned_areas_normalized_shares)
from similari_tpu_torch.ops import geometry as geo
from similari_tpu_torch.ops import ownarea as own

from torch_parity import one_cpu_thread

one_cpu_thread()

SHARE_TOL = 1e-5
ORACLE_TOL = 2e-3


def _scene(seed, d, spread, oriented, size=(4, 10)):
    rng = np.random.default_rng(seed)
    b = np.zeros((d, 5), np.float32)
    b[:, 0] = rng.uniform(0, spread, d)
    b[:, 1] = rng.uniform(0, spread, d)
    if oriented:
        b[:, 2] = rng.uniform(0, 1.2, d)
    b[:, 3] = rng.uniform(0.5, 2.0, d)
    b[:, 4] = rng.uniform(*size, d)
    return b


def _jax_shares(boxes, valid, order, neighbors):
    """JAX's shares.  Orders above 3 run eagerly: their jit compile takes
    ~16 s on the CPU, the eager run a few."""
    fn = jown.own_area_shares.__wrapped__ if order > 3 else jown.own_area_shares
    with jax.disable_jit(order > 3):
        return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(valid),
                             order=order, neighbors=neighbors))


def _shares(boxes, valid, order, neighbors):
    """(JAX's shares, the port's shares), padded to D=24 with invalid rows
    so that calls of one (order, neighbors) share one JAX compile."""
    d = boxes.shape[0]
    boxes = np.pad(boxes, [(0, 24 - d), (0, 0)])
    valid = np.pad(valid, (0, 24 - d))
    j = _jax_shares(boxes, valid, order, neighbors)
    p = own.own_area_shares(torch.tensor(boxes), torch.tensor(valid), order,
                            neighbors).numpy()
    assert (p[d:] == 1.0).all()
    return j[:d], p[:d]


def _host(boxes):
    return np.asarray(exclusively_owned_areas_normalized_shares([
        Universal2DBox(xc=float(b[0]), yc=float(b[1]), angle=float(b[2]),
                       aspect=float(b[3]), height=float(b[4]))
        for b in boxes]), np.float64)


@pytest.mark.parametrize("neighbors", [4, 8])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_own_area_shares_match_jax(order, neighbors):
    """A crowded scene of aligned boxes (the first half) and oriented ones
    (the second), which overlap each other too."""
    boxes = _scene(order * 10 + neighbors, 24, 30.0, True)
    boxes[:12, 2] = 0.0
    valid = np.random.default_rng(order).uniform(size=24) < 0.9
    j, p = _shares(boxes, valid, order, neighbors)
    np.testing.assert_allclose(p, j, rtol=SHARE_TOL, atol=SHARE_TOL)
    for half in (slice(0, 12), slice(12, 24)):
        assert (p[half][valid[half]] < 1.0).sum() > 3  # crowded
    assert (p[~valid] == 1.0).all()


@pytest.mark.parametrize("k", [2, 3])
def test_intersection_area_k_matches_jax(k):
    boxes = _scene(3, 3 * 40, 12.0, True).reshape(40, 3, 5)[:, :k]
    jv = jgeo.box_vertices(jnp.asarray(boxes))
    pv = geo.box_vertices(torch.tensor(boxes))
    j = np.asarray(jown.intersection_area_k(jv))
    p = own.intersection_area_k(pv).numpy()
    np.testing.assert_allclose(p, j, rtol=SHARE_TOL, atol=1e-4)
    assert (p > 0).sum() > 10


def test_intersection_area_k_identical_triple():
    """The collinear tie-break counts each shared edge once: three
    identical boxes intersect in the box itself."""
    b = torch.tensor([[0.0, 0.0, 0.3, 1.5, 2.0]])
    v = geo.box_vertices(b)[0]
    got = float(own.intersection_area_k(torch.stack([v, v, v])[None])[0])
    assert got == pytest.approx(float(geo.box_area(b)[0]), rel=1e-5)
    jv = jgeo.box_vertices(jnp.asarray(b.numpy()))[0]
    assert got == pytest.approx(
        float(jown.intersection_area_k(jnp.stack([jv, jv, jv])[None])[0]),
        rel=1e-6)


def test_deep_stack_brackets_and_matches_jax():
    """Five mutually overlapping boxes exceed the order-3/4 expansion: the
    odd order overestimates the own area, the even one underestimates it,
    and order 5 is exact (the host oracle); order 3 equals JAX's."""
    rng = np.random.default_rng(11)
    boxes = np.zeros((5, 5), np.float32)
    boxes[:, 0] = rng.uniform(-2, 2, 5)
    boxes[:, 1] = rng.uniform(-2, 2, 5)
    boxes[:, 2] = rng.uniform(0, 0.6, 5)
    boxes[:, 3] = rng.uniform(0.8, 1.4, 5)
    boxes[:, 4] = rng.uniform(6, 9, 5)
    valid = np.ones(5, bool)
    host = _host(boxes)
    got = {}
    j, got[3] = _shares(boxes, valid, 3, 4)
    np.testing.assert_allclose(got[3], j, rtol=SHARE_TOL, atol=SHARE_TOL)
    for order in (4, 5):
        got[order] = own.own_area_shares(torch.tensor(boxes),
                                         torch.tensor(valid), order,
                                         4).numpy()
    assert np.all(got[3] >= host - ORACLE_TOL)
    assert np.all(got[4] <= host + ORACLE_TOL)
    np.testing.assert_allclose(got[5], host, atol=ORACLE_TOL)


def test_tied_pair_areas_pick_the_lower_index_first():
    """A box with four equal overlaps (translated copies left, right,
    above, below) and two neighbour slots: the top-M must take the lower
    indices, as lax.top_k does, and the truncated shares show which were
    taken.  Far pairs all tie at area 0 too."""
    c = [(0.0, 0.0), (3.0, 0.0), (-3.0, 0.0), (0.0, 3.0), (0.0, -3.0),
         (3.0, 3.0), (500.0, 500.0)]
    boxes = np.array([[x, y, 0.0, 1.0, 4.0] for x, y in c], np.float32)
    valid = np.ones(len(c), bool)
    j, p = _shares(boxes, valid, 3, 2)
    np.testing.assert_allclose(p, j, rtol=SHARE_TOL, atol=SHARE_TOL)
    j8, p8 = _shares(boxes, valid, 3, 8)
    np.testing.assert_allclose(p8, j8, rtol=SHARE_TOL, atol=SHARE_TOL)
    assert not np.allclose(p, p8)  # the truncation picked a subset
    assert p[-1] == pytest.approx(1.0, abs=1e-6)  # the far box owns its area


def test_scene_axis_gives_each_scene_its_own_shares():
    scenes = [_scene(s, 16, 25.0, True) for s in range(3)]
    valid = np.ones((3, 16), bool)
    valid[1, 5:9] = False
    both = own.own_area_shares(torch.tensor(np.stack(scenes)),
                               torch.tensor(valid)).numpy()
    for s in range(3):
        one = own.own_area_shares(torch.tensor(scenes[s]),
                                  torch.tensor(valid[s])).numpy()
        np.testing.assert_allclose(both[s], one, rtol=1e-6, atol=1e-6)


def test_realistic_scene_matches_host_oracle():
    """A sparse MOT-like scene: the order-3 expansion is exact."""
    rng = np.random.default_rng(3)
    d = 40
    boxes = np.zeros((d, 5), np.float32)
    xy = np.stack(np.meshgrid(np.arange(8), np.arange(5)), -1).reshape(-1, 2)
    boxes[:, :2] = xy * 12.0 + rng.uniform(-3, 3, (d, 2))
    boxes[:, 2] = rng.uniform(0, 0.8, d)
    boxes[:, 3] = rng.uniform(0.5, 2, d)
    boxes[:, 4] = rng.uniform(4, 9, d)
    p = own.own_area_shares(torch.tensor(boxes), torch.ones(d, dtype=bool),
                            order=3).numpy()
    np.testing.assert_allclose(p, _host(boxes), atol=ORACLE_TOL)
