"""The port's Sutherland-Hodgman clip on tensors (`ops/geometry.py::
clip_polygon_quads`, `_clip_area_one`) and its LTWH IoU against the JAX
package, on the CPU.

Vertex counts must be equal; vertices are held at rtol 1e-5 / atol 1e-4
(both packages keep one operation order, so they agree to rounding; a
cos/sin of the box vertices may differ in its last bit); slots past the
count hold 0 in both.  The clipped polygon's area is held to the
Green's-theorem area (`quad_intersection_area`) at tests/test_geometry.py's
rtol 2e-3 / atol 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import geometry as G
from similari_tpu_torch.ops import geometry as PG

from torch_parity import one_cpu_thread

one_cpu_thread()

RTOL, ATOL = 1e-5, 1e-4


def _box_pairs(seed, n=512):
    """tests/test_geometry.py's random pairs in general position."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((2, n, 5), np.float32)
    for arr in boxes:
        arr[:, 0] = rng.uniform(-20, 20, n)
        arr[:, 1] = rng.uniform(-20, 20, n)
        arr[:, 2] = rng.uniform(0, 2 * np.pi, n)
        arr[:, 3] = rng.uniform(0.2, 3.0, n)
        arr[:, 4] = rng.uniform(1, 30, n)
    return boxes


def _quads(boxes):
    return np.asarray(G.box_vertices(jnp.asarray(boxes)))


def _exact_cases():
    """(name, subject box, clip box): nested, disjoint, a shared edge,
    axis-aligned overlap, identical (every edge parallel to one of the
    clip's), a corner touch."""
    def b(*v):
        return np.array(v, np.float32)
    return [
        ("nested", b(0, 0, 0.3, 1.0, 2.0), b(0, 0, 0.3, 1.0, 8.0)),
        ("disjoint", b(0, 0, 0.5, 1.0, 2.0), b(50, 0, 0.1, 1.0, 2.0)),
        ("shared_edge", b(0, 0, 0, 1.0, 2.0), b(2, 0, 0, 1.0, 2.0)),
        ("aligned", b(0, 0, 0, 2.0, 2.0), b(1, 1, 0, 1.0, 2.0)),
        ("identical", b(3, -4, 0.7, 1.5, 6.0), b(3, -4, 0.7, 1.5, 6.0)),
        ("corner", b(0, 0, 0, 1.0, 2.0), b(2, 2, 0, 1.0, 2.0)),
        ("octagon", b(0, 0, 0, 1.0, 2.0), b(0, 0, np.pi / 4, 1.0, 2.0)),
    ]


def _both(sub, clip):
    vj, nj = G.clip_polygon_quads(jnp.asarray(sub), jnp.asarray(clip))
    vp, np_ = PG.clip_polygon_quads(torch.tensor(sub), torch.tensor(clip))
    return (np.asarray(vj), np.asarray(nj)), (vp.numpy(), np_.numpy())


def test_clip_polygon_quads_matches_jax_on_random_pairs():
    boxes = _box_pairs(123)
    va, vb = _quads(boxes[0]), _quads(boxes[1])
    (vj, nj), (vp, np_) = _both(va, vb)
    assert vp.shape == (512, 8, 2) and np_.shape == (512,)
    np.testing.assert_array_equal(np_, nj)
    np.testing.assert_allclose(vp, vj, rtol=RTOL, atol=ATOL)
    assert (np_ >= 3).sum() > 100 and (np_ == 0).any()
    live = np.arange(8)[None, :] < np_[:, None]
    assert (vp[~live] == 0).all()


@pytest.mark.parametrize("name", [c[0] for c in _exact_cases()])
def test_clip_polygon_quads_exact_cases(name):
    """n equal to JAX's and to the geometry (e.g. 8 for the octagon);
    every slot finite, the dead ones 0, where a parallel edge's
    intersection is inf or NaN in its lane."""
    _, a, b = next(c for c in _exact_cases() if c[0] == name)
    sub, clip = _quads(a), _quads(b)
    (vj, nj), (vp, np_) = _both(sub, clip)
    np.testing.assert_array_equal(np_, nj)
    np.testing.assert_allclose(vp, vj, rtol=RTOL, atol=ATOL)
    assert np.isfinite(vp).all()
    assert (vp[int(np_):] == 0).all()
    want = {"disjoint": 0, "octagon": 8, "nested": 4, "aligned": 4,
            "identical": 4}
    if name in want:
        assert int(np_) == want[name]
    area = float(PG._clip_area_one(torch.tensor(sub), torch.tensor(clip)))
    green = float(PG.quad_intersection_area(torch.tensor(sub),
                                            torch.tensor(clip)))
    assert abs(area - green) <= 1e-2 + 2e-3 * green
    if name == "octagon":
        assert abs(area - 8 * (np.sqrt(2) - 1)) < 1e-4


def test_clip_area_matches_jax_and_green():
    """tests/test_geometry.py:182-197's cross-check, in the port, and the
    area helper against JAX's `_clip_area_one`."""
    boxes = _box_pairs(123)
    va, vb = _quads(boxes[0]), _quads(boxes[1])
    ap = PG._clip_area_one(torch.tensor(va), torch.tensor(vb))
    aj = np.asarray(G._clip_area_one(jnp.asarray(va), jnp.asarray(vb)))
    np.testing.assert_allclose(ap.numpy(), aj, rtol=RTOL, atol=ATOL)
    green = PG.quad_intersection_area(torch.tensor(va), torch.tensor(vb))
    np.testing.assert_allclose(green.numpy(), ap.numpy(), rtol=2e-3,
                               atol=1e-2)


def test_clip_polygon_quads_batch_dims_and_broadcast():
    """[S, P, 4, 2] batches give each pair's own result, and one clip quad
    broadcasts over many subjects."""
    boxes = _box_pairs(7, 24)
    va = _quads(boxes[0]).reshape(2, 12, 4, 2)
    vb = _quads(boxes[1]).reshape(2, 12, 4, 2)
    v, n = PG.clip_polygon_quads(torch.tensor(va), torch.tensor(vb))
    flat = PG.clip_polygon_quads(torch.tensor(va.reshape(24, 4, 2)),
                                 torch.tensor(vb.reshape(24, 4, 2)))
    assert torch.equal(v.reshape(24, 8, 2), flat[0])
    assert torch.equal(n.reshape(24), flat[1])
    one = torch.tensor(vb[0, 0])
    vb1, nb1 = PG.clip_polygon_quads(torch.tensor(va[0]), one)
    for i in range(12):
        vi, ni = PG.clip_polygon_quads(torch.tensor(va[0, i]), one)
        assert torch.equal(vb1[i], vi) and torch.equal(nb1[i], ni)


def test_aligned_iou_ltwh_matches_jax():
    rng = np.random.default_rng(31)
    a = np.zeros((64, 4), np.float32)
    b = np.zeros((64, 4), np.float32)
    for arr in (a, b):
        arr[:, :2] = rng.uniform(0, 100, (64, 2))
        arr[:, 2:] = rng.uniform(5, 40, (64, 2))
    b[::4] = a[::4]  # identical: IoU 1 up to the rounding of x + w - x
    b[1::4, 0] = a[1::4, 0] + a[1::4, 2]  # touching: 0
    for name in ("aligned_intersection_ltwh", "aligned_iou_ltwh"):
        j = np.asarray(getattr(G, name)(jnp.asarray(a[:, None]),
                                        jnp.asarray(b[None])))
        p = getattr(PG, name)(torch.tensor(a[:, None]), torch.tensor(b[None]))
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-6, atol=1e-6)
    iou = PG.aligned_iou_ltwh(torch.tensor(a), torch.tensor(b))
    torch.testing.assert_close(iou[::4], torch.ones(16), rtol=0, atol=1e-5)
    assert iou[1::4].eq(0).all() and (iou > 0).sum() > 16
