"""The port's Kalman filters: `ops/kalman.py` (box and point flavours,
candidate states, gather/scatter) and the public API of `utils/kalman.py`,
against the goldens of tests/test_kalman.py and tests/test_kalman_api.py
and against the JAX package, on the CPU.

`filter_sequence` (the port's C++ loop) is bit-equal to the JAX module's
default, native C++ path and within 1e-5 of its NumPy path (its native
branch switched off with monkeypatch); the port's NumPy twins
(`box_sequence_numpy`, `point_sequence_numpy`) are bit-equal to the
per-call API.  Malformed point shapes raise ValueError on every path
(the JAX module's unchecked shapes are not copied).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similari_tpu as jx
import similari_tpu_torch as pt
from similari_tpu import native
from similari_tpu.ops import kalman as JK
from similari_tpu_torch import (BoundingBox, Point2DKalmanFilter,
                                Universal2DBox, Universal2DBoxKalmanFilter,
                                Vec2DKalmanFilter)
from similari_tpu_torch.ops import kalman as K
from similari_tpu_torch.utils.kalman import (box_sequence_numpy,
                                             point_sequence_numpy)

from torch_parity import one_cpu_thread

one_cpu_thread()

SPEC = K.KalmanSpec()
POINT = K.KalmanSpec(kind="point")


def as_z(b):
    return torch.tensor(b.to_vec5(), dtype=torch.float32)


def state_box(s):
    return Universal2DBox.from_vec5(s.mean_pos.numpy())


# --------------------------------------------------------------------------
# ops/kalman.py: the goldens of tests/test_kalman.py
# --------------------------------------------------------------------------

def test_ops_constructor_roundtrip():
    bbox = BoundingBox(1.0, 2.0, 5.0, 5.0)
    s = SPEC.initiate(as_z(bbox.as_xyaah()))
    assert state_box(s).as_ltwh() == bbox


def test_ops_step_golden():
    s = SPEC.initiate(as_z(BoundingBox(-10.0, 2.0, 2.0, 5.0).as_xyaah()))
    s = SPEC.predict(s)
    assert state_box(s) == Universal2DBox(-9.0, 4.5, None, 0.4, 5.0)
    s = SPEC.update(s, as_z(Universal2DBox(8.75, 52.35, None, 0.150_849_15,
                                           100.1)))
    s = SPEC.predict(s)
    got = state_box(s)
    np.testing.assert_allclose(
        [got.xc, got.yc, got.aspect, got.height],
        [10.070248, 55.90909, 0.3951147, 107.173546], rtol=2e-5)


def test_ops_gating_distance():
    s = SPEC.initiate(as_z(BoundingBox(-10.0, 2.0, 2.0, 5.0).as_xyaah()))
    s = SPEC.predict(s)
    s = SPEC.update(s, as_z(BoundingBox(-9.5, 2.1, 2.0, 5.0).as_xyaah()))
    s = SPEC.predict(s)
    d1 = SPEC.distance(s, as_z(BoundingBox(-9.0, 2.2, 2.0, 5.0).as_xyaah()))
    c1 = float(K.calculate_cost(d1, False))
    assert 0.0 <= c1 < K.CHI2INV95[4]
    d2 = SPEC.distance(s, as_z(BoundingBox(-5.0, 1.5, 2.2, 5.0).as_xyaah()))
    assert float(K.calculate_cost(d2, False)) == K.CHI2_UPPER_BOUND


def test_ops_dense_matches_blocks():
    """The 2x2 blocks equal the dense 10x10 recurrences."""
    rng = np.random.default_rng(0)
    z0 = np.abs(rng.normal(size=5)).astype(np.float32) + 1.0
    z1 = z0 + rng.normal(size=5).astype(np.float32) * 0.1
    pw, vw = K.DEFAULT_POSITION_WEIGHT, K.DEFAULT_VELOCITY_WEIGHT
    F = np.eye(10, dtype=np.float32)
    for i in range(5):
        F[i, 5 + i] = 1.0
    H = np.eye(5, 10, dtype=np.float32)

    def stds(k, cnst, p, w):
        s = k * w * p
        return np.array([s, s, s, cnst, s], np.float32)

    mean = np.concatenate([z0, np.zeros(5, np.float32)])
    std = np.concatenate([stds(2, 1e-2, z0[4], pw), stds(10, 1e-5, z0[4], vw)])
    cov = np.diag(std * std)
    q = np.concatenate([stds(1, 1e-2, mean[4], pw),
                        stds(1, 1e-5, mean[4], vw)])
    cov = F @ cov @ F.T + np.diag(q * q)
    mean = F @ mean
    r = stds(1, 1e-1, mean[4], pw)
    S = H @ cov @ H.T + np.diag(r * r)
    gain = np.linalg.solve(np.tril(S), (cov @ H.T).T)
    mean = mean + ((z1 - H @ mean)[None, :] @ gain)[0]
    cov = cov - gain.T @ S @ gain
    s = K.step_track_states(SPEC, SPEC.initiate(torch.tensor(z0)),
                            torch.tensor(z1))
    np.testing.assert_allclose(s.mean().numpy(), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.dense_covariance().numpy(), cov, rtol=1e-4,
                               atol=1e-6)


def test_ops_candidate_state_mean_equals_observation():
    z = torch.tensor([[10.0, 20.0, 0.0, 0.5, 8.0], [1.0, 2.0, 0.3, 1.0, 3.0]])
    s = K.make_candidate_states(SPEC, z)
    np.testing.assert_allclose(s.mean_pos.numpy(), z.numpy(), rtol=1e-6)
    for i in range(2):  # batched == single
        one = K.make_candidate_states(SPEC, z[i])
        np.testing.assert_array_equal(s.cpp[i].numpy(), one.cpp.numpy())


def test_ops_point_filter_basic():
    s = POINT.predict(POINT.initiate(torch.tensor([1.0, 2.0])))
    np.testing.assert_allclose(s.mean_pos.numpy(), [1.0, 2.0], atol=1e-6)
    s = POINT.update(s, torch.tensor([1.5, 2.5]))
    m = s.mean_pos.numpy()
    assert 1.0 < m[0] < 1.5 and 2.0 < m[1] < 2.5
    assert float(POINT.distance(s, torch.tensor([1.5, 2.5]))) >= 0.0
    assert s.dim == 2 and s.dense_covariance().shape == (4, 4)


# --------------------------------------------------------------------------
# ops/kalman.py against the JAX package
# --------------------------------------------------------------------------

def _kf_fields(s):
    return [np.asarray(getattr(s, n))
            for n in ("mean_pos", "mean_vel", "cpp", "cpv", "cvv")]


@pytest.mark.parametrize("kind", ["point", "box"])
def test_ops_filters_match_jax(kind):
    rng = np.random.default_rng(5)
    dim = 2 if kind == "point" else 5
    z = [np.abs(rng.normal(size=(7, dim))).astype(np.float32) * 20 + 1
         for _ in range(4)]
    spec_j = JK.KalmanSpec(0.07, 0.01, kind=kind)
    spec_p = K.KalmanSpec(0.07, 0.01, kind=kind)
    sj = JK.make_candidate_states(spec_j, jnp.asarray(z[0]))
    sp = K.make_candidate_states(spec_p, torch.tensor(z[0]))
    for zi in z[1:]:
        sj = JK.step_track_states(spec_j, sj, jnp.asarray(zi))
        sp = K.step_track_states(spec_p, sp, torch.tensor(zi))
        for a, b in zip(_kf_fields(sp), _kf_fields(sj)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            spec_p.distance(sp, torch.tensor(zi)).numpy(),
            np.asarray(spec_j.distance(sj, jnp.asarray(zi))), rtol=1e-5)
        np.testing.assert_allclose(
            spec_p.distance_matrix(sp, torch.tensor(zi)).numpy(),
            np.asarray(spec_j.distance_matrix(sj, jnp.asarray(zi))),
            rtol=1e-5)
    np.testing.assert_allclose(sp.dense_covariance().numpy(),
                               np.asarray(sj.dense_covariance()), rtol=1e-6,
                               atol=1e-7)


def test_ops_gather_scatter_match_jax():
    rng = np.random.default_rng(6)
    dst_np = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(5)]
    src_np = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(5)]
    idx = np.array([4, 0, 9, 2], np.int32)  # 9: out of range, dropped
    mask = np.array([True, True, True, False])
    dj = JK.KalmanState(*map(jnp.asarray, dst_np))
    dp = K.KalmanState(*map(torch.tensor, dst_np))
    out_j = JK.scatter_state(dj, jnp.asarray(idx),
                             JK.KalmanState(*map(jnp.asarray, src_np)),
                             jnp.asarray(mask))
    out_p = K.scatter_state(dp, torch.tensor(idx),
                            K.KalmanState(*map(torch.tensor, src_np)),
                            torch.tensor(mask))
    for a, b in zip(_kf_fields(out_p), _kf_fields(out_j)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dp.cpp.numpy(), dst_np[2])  # not modified
    g = torch.tensor([5, 1, 1])
    for a, b in zip(_kf_fields(K.gather_state(dp, g)),
                    _kf_fields(JK.gather_state(dj, jnp.asarray(g.numpy())))):
        np.testing.assert_array_equal(a, b)
    e = K.empty_state(3, 2, device="cpu")
    assert e.mean_pos.shape == (3, 2) and e.cvv.dtype == torch.float32


# --------------------------------------------------------------------------
# utils/kalman.py: the goldens of tests/test_kalman_api.py
# --------------------------------------------------------------------------

def test_box_filter_roundtrip_and_golden():
    f = Universal2DBoxKalmanFilter()
    bbox = BoundingBox(1.0, 2.0, 5.0, 5.0)
    assert f.initiate(bbox.as_xyaah()).bbox() == bbox
    state = f.initiate(BoundingBox(-10.0, 2.0, 2.0, 5.0).as_xyaah())
    state = f.predict(state)
    assert state.universal_bbox() == Universal2DBox(-9.0, 4.5, None, 0.4, 5.0)
    state = f.update(state, Universal2DBox(8.75, 52.35, None, 0.150_849_15,
                                           100.1))
    state = f.predict(state)
    assert state.universal_bbox() == Universal2DBox(
        10.070248, 55.90909, None, 0.3951147, 107.173546)


def test_box_filter_cost():
    assert Universal2DBoxKalmanFilter.calculate_cost(5.0, False) == 5.0
    assert Universal2DBoxKalmanFilter.calculate_cost(50.0, False) == 100.0
    assert Universal2DBoxKalmanFilter.calculate_cost(5.0, True) == 95.0
    assert Universal2DBoxKalmanFilter.calculate_cost(50.0, True) == 0.0


def test_point_and_vec_filters():
    f = Point2DKalmanFilter()
    s = f.predict(f.initiate(1.0, 2.0))
    assert s.x() == pytest.approx(1.0) and s.y() == pytest.approx(2.0)
    s = f.update(s, 1.5, 2.5)
    assert 1.0 < s.x() < 1.5 and f.distance(s, 1.5, 2.5) >= 0.0
    v = Vec2DKalmanFilter()
    states = v.predict(v.initiate([(0.0, 0.0), (5.0, 5.0)]))
    states = v.update(states, [(0.1, 0.1), (5.1, 5.1)])
    assert len(states) == 2 and states[1].x() > 5.0
    costs = Vec2DKalmanFilter.calculate_cost(
        v.distance(states, [(0.1, 0.1), (5.1, 5.1)]), False)
    assert len(costs) == 2
    assert Point2DKalmanFilter.calculate_cost(7.0, False) == 100.0
    assert Point2DKalmanFilter.calculate_cost(7.0, True) == 93.0


def _box_track(seed, n=200):
    rng = np.random.default_rng(seed)
    z = np.zeros((n, 5), np.float32)
    z[:, 0] = np.cumsum(rng.normal(size=n)).astype(np.float32)
    z[:, 1] = np.cumsum(rng.normal(size=n)).astype(np.float32)
    z[:, 3] = 2.0
    z[:, 4] = 5.0 + rng.uniform(0, 1, n).astype(np.float32)
    return z


def test_filter_sequence_matches_per_call_api():
    """The NumPy twins are the per-call loop bit for bit; the C++ loop of
    `filter_sequence` is within the JAX package's own tolerance for its
    native loop (tests/test_kalman_api.py: rtol = atol = 1e-5)."""
    z = _box_track(9)
    kf = Universal2DBoxKalmanFilter()
    st = kf.initiate(Universal2DBox.from_vec5(z[0]))
    want = [st._state.mean_pos.copy()]
    for i in range(1, len(z)):
        st = kf.update(kf.predict(st), Universal2DBox.from_vec5(z[i]))
        want.append(st._state.mean_pos.copy())
    np.testing.assert_array_equal(
        box_sequence_numpy(z, kf._f.pw, kf._f.vw), np.stack(want))
    np.testing.assert_allclose(kf.filter_sequence(z), np.stack(want),
                               rtol=1e-5, atol=1e-5)
    pz = np.cumsum(np.random.default_rng(10).normal(size=(50, 2)),
                   axis=0).astype(np.float32)
    pkf = Point2DKalmanFilter()
    st = pkf.initiate(float(pz[0, 0]), float(pz[0, 1]))
    want = [st._state.mean_pos.copy()]
    for i in range(1, len(pz)):
        st = pkf.update(pkf.predict(st), float(pz[i, 0]), float(pz[i, 1]))
        want.append(st._state.mean_pos.copy())
    np.testing.assert_array_equal(
        point_sequence_numpy(pz, pkf._f.pw, pkf._f.vw), np.stack(want))
    np.testing.assert_allclose(pkf.filter_sequence(pz), np.stack(want),
                               rtol=1e-5, atol=1e-5)


def _sequences():
    rng = np.random.default_rng(11)
    return {"box": _box_track(12, 120),
            "point": np.cumsum(rng.normal(size=(80, 2)), axis=0).astype(
                np.float32),
            "vec": np.cumsum(rng.normal(size=(40, 7, 2)), axis=0).astype(
                np.float32)}


FILTERS = {"box": "Universal2DBoxKalmanFilter",
           "point": "Point2DKalmanFilter", "vec": "Vec2DKalmanFilter"}


@pytest.mark.parametrize("kind", sorted(FILTERS))
@pytest.mark.parametrize("path", ["numpy", "native"])
def test_filter_sequence_matches_jax(kind, path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "kf_box_sequence", lambda *a: None)
        monkeypatch.setattr(native, "kf_point_sequence", lambda *a: None)
    z = _sequences()[kind]
    got = getattr(jx, FILTERS[kind])(0.06, 0.01).filter_sequence(z)
    ours = getattr(pt, FILTERS[kind])(
        0.06, 0.01).filter_sequence(z)
    assert ours.shape == z.shape and ours.dtype == np.float32
    if path == "native":
        np.testing.assert_array_equal(ours, got)
    else:
        np.testing.assert_allclose(ours, got, rtol=1e-5, atol=1e-5)
        twin = (box_sequence_numpy if kind == "box"
                else point_sequence_numpy)(z, 0.06, 0.01)
        np.testing.assert_array_equal(twin, got)
    empty = np.zeros((0,) + z.shape[1:], np.float32)
    assert getattr(pt, FILTERS[kind])(
    ).filter_sequence(empty).shape == empty.shape


@pytest.mark.parametrize("kind,shape", [
    ("point", (5, 3, 2)), ("point", (5, 1)), ("point", (5,)),
    ("vec", (5, 3, 1)), ("vec", (5, 2)), ("vec", (5, 3, 2, 1)),
    ("box", (5, 4)), ("box", (5, 1, 5))])
def test_malformed_shapes_raise(kind, shape):
    f = getattr(pt, FILTERS[kind])()
    with pytest.raises(ValueError, match="must be"):
        f.filter_sequence(np.zeros(shape, np.float32))
