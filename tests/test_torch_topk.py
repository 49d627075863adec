"""The port's radius-pruned top-k rotated IoU (`ops/geometry.py::
rotated_intersection_topk`) and the paths that reach it (`nms_kernel(
neighbors > 0)`, `oriented_neighbors` of the SORT and VisualSORT steps and
of the batched step) against the JAX package, on the CPU.

IoU values are held at 2e-4, the tolerance tests/test_torch_geometry.py
holds the dense form to; validity, keep masks, ids, slots, voting types
and is_new must be equal; states at torch_parity.RTOL/ATOL.  Which k
partners a row keeps is part of the result: among equal distances the
lower column wins, as `jax.lax.top_k` orders ties, so the crowded cases
put duplicate track boxes at the cut.

NaN: the JAX package gathers the partners and scatters the results with
one-hot contractions, so one NaN box turns every pair of the matrix into
0 x NaN = NaN.  The port gathers natively; a NaN box is never a candidate
and touches no other pair.  The NaN cases hold the port's top-k form to
the dense form of both packages, never to JAX's top-k form, and pin JAX's
smear as a divergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import geometry as G
from similari_tpu.ops.nms import nms_kernel as jax_nms
from similari_tpu.parallel import mesh as jmesh
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.sort_step import compiled_sort_scan
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state
from similari_tpu.trackers.visual_state import (
    new_visual_state as jax_new_visual_state)
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu.trackers.visual_step import compiled_visual_scan
from similari_tpu_torch.convert import (sort_state_from_numpy,
                                        sort_state_to_numpy,
                                        visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.ops import geometry as PG
from similari_tpu_torch.ops.nms import nms_kernel
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan
from similari_tpu_torch.trackers.state import new_sort_state
from similari_tpu_torch.trackers.visual_step import VisualConfig, visual_scan

from torch_parity import (VISUAL_CONFIGS, assert_state_dicts_match,
                          crowded_stream, jax_state_dict, one_cpu_thread)

one_cpu_thread()

CPU = torch.device("cpu")
TOL = 2e-4
OUTPUTS = ("slot", "track_id", "is_new", "length", "overflow")


def _boxes(rng, n, spread):
    """tests/test_geometry.py's boxes: angles U(0, 1.4), 15-40 px."""
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, spread, n)
    b[:, 1] = rng.uniform(0, spread, n)
    b[:, 2] = rng.uniform(0, 1.4, n)
    b[:, 3] = rng.uniform(0.4, 1.6, n)
    b[:, 4] = rng.uniform(15, 40, n)
    return b


def _partners(a, b):
    """Not-too-far partners per row of a[D, 5] x b[T, 5]."""
    a, b = torch.tensor(a), torch.tensor(b)
    return (~PG.too_far(a[:, None], b[None])).sum(1)


def _both(a, b, k):
    """(JAX, port) universal_iou_matrix with neighbors=k, as numpy."""
    j = G.universal_iou_matrix(jnp.asarray(a), jnp.asarray(b), True,
                               neighbors=k)
    p = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b), True,
                                neighbors=k)
    return [np.asarray(x) for x in j], [x.numpy() for x in p]


def test_topk_iou_matches_jax_and_dense():
    """tests/test_geometry.py's sparse case (D=48, T=96, k=16): equal to
    JAX's top-k form, and to the port's dense form, since no row has more
    than k partners."""
    rng = np.random.default_rng(17)
    a, b = _boxes(rng, 48, 900.0), _boxes(rng, 96, 900.0)
    assert int(_partners(a, b).max()) <= 16
    (ij, vj), (ip, vp) = _both(a, b, 16)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(ip, ij, rtol=TOL, atol=TOL)
    assert vp.any()
    idn, vdn = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b),
                                       True, neighbors=0)
    np.testing.assert_array_equal(vp, vdn.numpy())
    np.testing.assert_allclose(ip, idn.numpy(), rtol=1e-6, atol=1e-7)


def _tied_case():
    """Rows with 10 partners each, k=5 at a tie: two tracks near each
    detection at distinct distances, then 8 identical tracks at one equal
    distance, their columns interleaved with the other rows' tracks."""
    rng = np.random.default_rng(5)
    d, per = 4, 10
    a = _boxes(rng, d, 1.0)
    a[:, 0] = np.arange(d) * 400.0 + 50.0
    a[:, 1] = 60.0
    b = np.zeros((d * per, 5), np.float32)
    for r in range(d):
        cols = np.arange(r, d * per, d)  # interleaved columns of row r
        b[cols] = a[r]
        b[cols[0], 0] += 1.0
        b[cols[1], 0] += 2.0
        b[cols[2:], 1] += 3.0  # 8 duplicates at distance 3
        b[cols, 2] = rng.uniform(0, 1.4)
    return a, b, 5


def test_topk_crowded_ties_match_jax():
    """More than k partners per row with duplicates at the cut: the port
    keeps the partners JAX keeps (the lower columns of the tie), and the
    IoU matrix equals JAX's."""
    a, b, k = _tied_case()
    assert (_partners(a, b) == 10).all()
    (ij, vj), (ip, vp) = _both(a, b, k)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(ip, ij, rtol=TOL, atol=TOL)
    for r in range(a.shape[0]):
        cols = np.arange(r, b.shape[0], a.shape[0])
        assert np.flatnonzero(vp[r]).tolist() == cols[:k].tolist()
    inter = PG.rotated_intersection_topk(torch.tensor(a), torch.tensor(b), k)
    np.testing.assert_allclose(
        inter.numpy(), np.asarray(G.rotated_intersection_topk(
            jnp.asarray(a), jnp.asarray(b), k)), rtol=TOL, atol=TOL)


def test_topk_takes_a_scene_axis():
    """[S, D, 5] x [S, T, 5], as the batched steps pass them: each scene
    equals its own run."""
    rng = np.random.default_rng(3)
    a = np.stack([_boxes(rng, 12, 120.0) for _ in range(3)])
    b = np.stack([_boxes(rng, 20, 120.0) for _ in range(3)])
    iou, valid = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b),
                                         True, neighbors=3)
    assert iou.shape == (3, 12, 20)
    for s in range(3):
        one = PG.universal_iou_matrix(torch.tensor(a[s]), torch.tensor(b[s]),
                                      True, neighbors=3)
        assert torch.equal(iou[s], one[0]) and torch.equal(valid[s], one[1])
    assert int(valid.sum(-1).max()) == 3 < int(_partners(a[0], b[0]).max())


def test_topk_nan_track_box_matches_dense():
    """A NaN track box: the port's top-k result equals both packages'
    dense results.  JAX's top-k form returns NaN for every pair and no
    valid pair: its one-hot gather multiplies the NaN row by 0 for every
    slot (the divergence this test pins)."""
    rng = np.random.default_rng(17)
    a, b = _boxes(rng, 8, 200.0), _boxes(rng, 40, 200.0)
    b[7] = np.nan
    (ij, vj), (ip, vp) = _both(a, b, 8)
    jd, vjd = G.universal_iou_matrix(jnp.asarray(a), jnp.asarray(b), True)
    pd, vpd = PG.universal_iou_matrix(torch.tensor(a), torch.tensor(b), True)
    assert vp.sum() > 0 and int(_partners(a, b).max()) <= 8
    np.testing.assert_array_equal(vp, vpd.numpy())
    np.testing.assert_array_equal(ip, pd.numpy())
    np.testing.assert_array_equal(vp, np.asarray(vjd))
    np.testing.assert_allclose(ip, np.asarray(jd), rtol=TOL, atol=TOL)
    inter_j = np.asarray(G.rotated_intersection_topk(jnp.asarray(a),
                                                     jnp.asarray(b), 8))
    assert np.isnan(inter_j).all() and not vj.any()
    inter_p = PG.rotated_intersection_topk(torch.tensor(a), torch.tensor(b),
                                           8)
    assert torch.isfinite(inter_p).all() and inter_p[:, 7].eq(0).all()


def test_nms_topk_matches_jax():
    """tests/test_geometry.py's n=128 frame with neighbors=32 keeps what
    the dense route keeps, in both packages."""
    rng = np.random.default_rng(23)
    n = 128
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, 400, n)
    b[:, 1] = rng.uniform(0, 400, n)
    b[:, 2] = rng.uniform(0, 0.8, n)
    b[:, 3] = rng.uniform(0.5, 1.5, n)
    b[:, 4] = rng.uniform(20, 50, n)
    order = np.argsort(-rng.uniform(0.5, 1.0, n).astype(np.float32))
    b = b[order]
    valid = np.ones(n, bool)
    want = np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(valid),
                              jnp.float32(0.7), True, 32))
    got = nms_kernel(torch.tensor(b), torch.tensor(valid), 0.7, True, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    dense = nms_kernel(torch.tensor(b), torch.tensor(valid), 0.7, True, 0)
    assert torch.equal(got, dense)


def test_nms_topk_crowded_matches_jax():
    """A crowd where the prune changes the result: clusters of 12 boxes,
    some of them duplicates, with neighbors=3.  The keep mask equals
    JAX's pruned one and differs from the dense one."""
    rng = np.random.default_rng(29)
    n = 96
    b = np.zeros((n, 5), np.float32)
    centres = rng.uniform(0, 600, (n // 12, 2))
    b[:, :2] = np.repeat(centres, 12, axis=0) + rng.uniform(-6, 6, (n, 2))
    b[:, 2] = rng.uniform(0, 0.8, n)
    b[:, 3] = rng.uniform(0.6, 1.4, n)
    b[:, 4] = rng.uniform(25, 40, n)
    b[1::12] = b[0::12]  # exact duplicates: equal distances
    b = b[rng.permutation(n)]
    valid = np.ones(n, bool)
    valid[5] = False
    keeps = {}
    for nb in (0, 3):
        want = np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(valid),
                                  jnp.float32(0.3), True, nb))
        got = nms_kernel(torch.tensor(b), torch.tensor(valid), 0.3, True, nb)
        np.testing.assert_array_equal(got.numpy(), want)
        keeps[nb] = want
    assert (keeps[0] != keeps[3]).any()


def _crowd(seed, steps=8, d=16, n=12, spread=100.0):
    """crowded_stream with angles: two exact copies per frame (equal
    detection boxes, and so tracks at equal distances)."""
    box, conf, valid = crowded_stream(seed, steps, d, n, 16, spread,
                                      copies=2)[:3]
    box = box.copy()
    box[..., 2] = np.random.default_rng(seed + 1).uniform(0, 0.6,
                                                          box.shape[:2])
    return box, conf, valid


SORT_KW = dict(method="iou", assignment="auction", max_idle_epochs=5,
               oriented=True, oriented_block_sort=False)


@pytest.mark.parametrize("k,spread", [(4, 100.0), (2, 80.0)])
def test_sort_scan_topk_matches_jax(k, spread):
    """Capacity 64 >= 4k turns the prune on; in this crowd it changes the
    ids against the dense form, and the port follows JAX."""
    box, conf, valid = _crowd(0, spread=spread)
    ep = np.arange(1, 9, dtype=np.int32)
    runs = {}
    for nb in (0, k):
        kw = dict(SORT_KW, oriented_neighbors=nb)
        st = jax_new_sort_state(64, 1)
        start = jax_state_dict(st)
        sj, oj = compiled_sort_scan(JaxSortConfig(**kw))(
            st, jnp.asarray(box), jnp.asarray(conf), jnp.asarray(valid),
            jnp.asarray(ep))
        sp, op = sort_scan(SortConfig(**kw), sort_state_from_numpy(start, CPU),
                           torch.tensor(box), torch.tensor(conf),
                           torch.tensor(valid), ep)
        for name in OUTPUTS:
            np.testing.assert_array_equal(getattr(op, name).numpy(),
                                          np.asarray(getattr(oj, name)),
                                          err_msg=f"{name} (neighbors {nb})")
        assert_state_dicts_match(jax_state_dict(sj), sort_state_to_numpy(sp))
        runs[nb] = op.track_id.numpy()
    assert (runs[0] != runs[k]).any()


def test_sort_scan_topk_needs_4k_capacity(monkeypatch):
    """The prune runs when capacity >= 4k and the state has more than k
    slots, as in the JAX package; otherwise the dense form runs."""
    calls = []
    topk = PG.rotated_intersection_topk
    monkeypatch.setattr(PG, "rotated_intersection_topk",
                        lambda *a: calls.append(a[2]) or topk(*a))
    box, conf, valid = _crowd(0, steps=2)
    for k, capacity, want in ((4, 16, [4, 4]), (4, 15, []), (20, 64, []),
                              (16, 64, [16, 16])):
        calls.clear()
        sort_scan(SortConfig(**dict(SORT_KW, oriented_neighbors=k)),
                  new_sort_state(capacity, 1, device=CPU), torch.tensor(box),
                  torch.tensor(conf), torch.tensor(valid), 1)
        assert calls == want, (k, capacity)


def test_visual_scan_topk_matches_jax():
    box, conf, valid, feat, fvalid, qual, oa = crowded_stream(
        1, 8, 16, 12, 16, 100.0, copies=2)
    box = box.copy()
    box[..., 2] = np.random.default_rng(2).uniform(0, 0.6, box.shape[:2])
    stream = (box, conf, valid, feat, fvalid, qual, oa)
    kw = dict(VISUAL_CONFIGS["euclid_iou"], oriented=True,
              oriented_neighbors=4)
    st = jax_new_visual_state(64, 1, 3, 16)
    start = jax_state_dict(st)
    sj, oj = compiled_visual_scan(JaxVisualConfig(**kw))(
        st, *(jnp.asarray(x) for x in stream), jnp.asarray(1))
    sp, op = visual_scan(VisualConfig(**kw),
                         visual_state_from_numpy(start, CPU),
                         *(torch.tensor(x) for x in stream), 1)
    for name in OUTPUTS + ("voting_type",):
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)),
                                      err_msg=name)
    assert_state_dicts_match(jax_state_dict(sj), visual_state_to_numpy(sp))


def test_batched_sort_step_topk_matches_jax():
    """S=3 crowded scenes stepped together with oriented_neighbors=4: every
    output of every frame equals JAX's vmapped step."""
    s, t = 3, 64
    scenes = [_crowd(seed, steps=4) for seed in range(s)]
    box, conf, valid = (np.stack(x, axis=1) for x in zip(*scenes))
    kw = dict(SORT_KW, oriented_neighbors=4)
    js = jmesh.new_batched_state(s, t, 1)
    ps = sort_state_from_numpy(jax_state_dict(js), CPU)
    jstep = jax.jit(jmesh.batched_sort_step(JaxSortConfig(**kw)))
    pstep = pmesh.batched_sort_step(SortConfig(**kw))
    for i in range(box.shape[0]):
        ep = np.full(s, i + 1, np.int32)
        js, oj = jstep(js, jnp.asarray(box[i]), jnp.asarray(conf[i]),
                       jnp.asarray(valid[i]), jnp.asarray(ep))
        ps, op = pstep(ps, torch.tensor(box[i]), torch.tensor(conf[i]),
                       torch.tensor(valid[i]), torch.tensor(ep))
        for name in OUTPUTS:
            np.testing.assert_array_equal(getattr(op, name).numpy(),
                                          np.asarray(getattr(oj, name)),
                                          err_msg=f"frame {i} {name}")
    assert_state_dicts_match(jax_state_dict(js), sort_state_to_numpy(ps))


def test_sort_scan_topk_zero_height_matches_dense():
    """A valid zero-height detection opens a track whose Kalman state is
    NaN.  The port's top-k step then gives the dense step's ids and
    slots; JAX's top-k form would lose every IoU pair of the frame (see
    test_topk_nan_track_box_matches_dense), and its XLA step smears the
    NaN over the state anyway, so JAX's step is no oracle here."""
    box, conf, valid = _crowd(4, spread=300.0)
    box[2, 3, 4] = 0.0
    runs = []
    for nb in (0, 4):
        st, o = sort_scan(SortConfig(**dict(SORT_KW, oriented_neighbors=nb)),
                          new_sort_state(64, 1, device=CPU),
                          torch.tensor(box), torch.tensor(conf),
                          torch.tensor(valid), 1)
        runs.append((st, o))
    (sd, od), (sk, ok) = runs
    assert torch.isnan(sd.pred_box).any()  # the NaN track exists
    for name in OUTPUTS:
        assert torch.equal(getattr(ok, name), getattr(od, name)), name
    assert (~od.is_new[3:] & torch.tensor(valid[3:])).sum() > 0
