"""The port's multi-scene steps (`parallel/mesh.py`) and its in-place merge
(`ops/merge_inplace.py`, plain version on the CPU) against the JAX
package's vmapped steps and Pallas merge kernel (interpret mode).

Ids, voting types, is_new, overflow flags and next_id must be equal;
floats as in tests/torch_parity.py.  Every scene of a batch must equal its
own single-scene run: a batch-wide reduction (auction eps, new-track
count, overflow, next id) would change one scene through another's data,
so the batches put an overflowing scene and a contended one beside a
quiet one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops.pallas_merge import lane_merge_inplace as jax_merge
from similari_tpu.parallel import mesh as jmesh
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.convert import (sort_state_from_numpy,
                                        sort_state_to_numpy,
                                        visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.ops import geometry as geo
from similari_tpu_torch.ops import kalman as kal
from similari_tpu_torch.ops.merge_inplace import (lane_merge_inplace,
                                                  lane_merge_plain)
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan
from similari_tpu_torch.trackers.state import map_tensors
from similari_tpu_torch.trackers.visual_step import (VT_VISUAL, VisualConfig,
                                                     visual_scan)

from torch_parity import (ATOL, RTOL, VISUAL_CONFIGS,
                          assert_state_dicts_match, crowded_stream,
                          jax_state_dict, one_cpu_thread, oriented_stream,
                          sort_overflow_stream, visual_overflow_stream,
                          visual_stream)

one_cpu_thread()

CPU = torch.device("cpu")
S, N, D, T, K, F = 3, 8, 16, 32, 3, 16


# --------------------------------------------------------------------------
# the in-place merge
# --------------------------------------------------------------------------

def _merge_case(seed, s, r, d, f, dtype):
    """state, src, row (unique per scene, some outside [0, R) with valid
    0), valid as numpy; bf16 values are bf16-exact float32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        state = rng.integers(-50, 50, (s, r, f)).astype(np.int32)
        src = rng.integers(-50, 50, (s, d, f)).astype(np.int32)
    else:
        state = rng.normal(size=(s, r, f)).astype(np.float32)
        src = rng.normal(size=(s, d, f)).astype(np.float32)
        if dtype == "bf16":
            state = torch.tensor(state).bfloat16().float().numpy()
            src = torch.tensor(src).bfloat16().float().numpy()
    row = np.stack([rng.permutation(r)[:d] for _ in range(s)]).astype(
        np.int32)
    valid = (rng.uniform(size=(s, d)) < 0.8).astype(np.int32)
    row[:, 0], valid[:, 0] = -1, 0
    row[:, 1], valid[:, 1] = r + 2, 0
    return state, src, row, valid


def _loop(state, src, row, valid):
    out = state.copy()
    for i in range(row.shape[0]):
        for j in range(row.shape[1]):
            if valid[i, j]:
                out[i, row[i, j]] = src[i, j]
    return out


_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int32": jnp.int32}


@pytest.mark.parametrize("dtype,f", [("f32", 128), ("int32", 128),
                                     ("bf16", 256)])
def test_lane_merge_plain_matches_pallas(dtype, f):
    state, src, row, valid = _merge_case(0, 4, 24, 8, f, dtype)
    # the Pallas kernel requires rows inside [0, R)
    jrow = np.clip(row, 0, 23)
    j = jax_merge(jnp.asarray(state, _JAX[dtype]),
                  jnp.asarray(src, _JAX[dtype]), jnp.asarray(jrow),
                  jnp.asarray(valid), interpret=True)
    ts = torch.tensor(state).to(_TORCH[dtype])
    p = lane_merge_plain(ts, torch.tensor(src).to(_TORCH[dtype]),
                         torch.tensor(row), torch.tensor(valid))
    assert p is ts
    np.testing.assert_array_equal(p.float().numpy(),
                                  np.asarray(j).astype(np.float32))


@pytest.mark.parametrize("dtype,f", [("bf16", 3), ("f32", 129),
                                     ("int32", 5), ("bf16", 512)])
def test_lane_merge_inplace_matches_loop(dtype, f):
    """Widths the TPU kernel refuses; rows outside [0, R) never write."""
    state, src, row, valid = _merge_case(1, 3, 20, 7, f, dtype)
    ts = torch.tensor(state).to(_TORCH[dtype])
    ptr = ts.data_ptr()
    out = lane_merge_inplace(ts, torch.tensor(src).to(_TORCH[dtype]),
                             torch.tensor(row), torch.tensor(valid))
    assert out is ts and out.data_ptr() == ptr
    np.testing.assert_array_equal(out.float().numpy(),
                                  _loop(state, src, row, valid))


def test_lane_merge_inplace_checks_its_inputs():
    state = torch.zeros(2, 6, 4)
    src = torch.zeros(2, 3, 4)
    row = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        lane_merge_inplace(state, src.bfloat16(), row, row)
    with pytest.raises(TypeError):
        lane_merge_inplace(state, src, row.long(), row)
    with pytest.raises(ValueError, match="contiguous"):
        lane_merge_inplace(state.transpose(1, 2).contiguous().transpose(1, 2),
                           src, row, row)
    with pytest.raises(ValueError):
        lane_merge_inplace(state, src[:, :, :3], row, row)
    with pytest.raises(ValueError):
        lane_merge_inplace(state, src, row[:, :2], row)


# --------------------------------------------------------------------------
# batched steps against the JAX package's vmapped steps
# --------------------------------------------------------------------------

VCFG = dict(VISUAL_CONFIGS["euclid_iou"], recycle_idle=True)


def _visual_scenes():
    """[N, S, ...]: a quiet scene, one that overflows T=32 from its third
    frame, and a crowded one whose auction contends."""
    quiet = visual_stream(0, N, D, F)
    over = visual_overflow_stream(N, D, F)
    crowd = crowded_stream(0, N, D, 12, F, 133.0, noise=2.0, copies=1)
    return [np.stack([a, b, c], axis=1) for a, b, c in zip(quiet, over,
                                                           crowd)]


def _sort_scenes():
    box0, conf0, valid0 = oriented_stream(0, N, D, oriented=False)
    box1, valid1 = sort_overflow_stream(N, D)
    box2, conf2, valid2 = crowded_stream(0, N, D, 12, F, 133.0,
                                         copies=1)[:3]
    return [np.stack(x, axis=1) for x in (
        (box0, box1, box2), (conf0, np.ones_like(conf0), conf2),
        (valid0, valid1, valid2))]


@pytest.fixture(scope="module")
def visual_runs():
    """JAX's and the port's batched visual scans over the same scenes."""
    arrs = _visual_scenes()
    ep0 = np.array([1, 5, 2], np.int32)
    js = jmesh.new_batched_visual_state(S, T, 1, K, F)
    start = jax_state_dict(js)
    sj, oj = jax.jit(jmesh.batched_visual_scan(JaxVisualConfig(**VCFG)))(
        js, *map(jnp.asarray, arrs), jnp.asarray(ep0))
    sp, op = pmesh.batched_visual_scan(VisualConfig(**VCFG))(
        visual_state_from_numpy(start, CPU), *map(torch.tensor, arrs),
        torch.tensor(ep0))
    return arrs, ep0, (jax_state_dict(sj), oj), (sp, op)


def test_batched_visual_scan_matches_jax(visual_runs):
    _, _, (sj, oj), (sp, op) = visual_runs
    for name, j, p in zip(("track_id", "voting_type", "overflow"), oj, op):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    assert_state_dicts_match(sj, visual_state_to_numpy(sp))
    ovf = op[2].numpy()
    assert ovf[:, 1].any() and not ovf[:, 0].any()  # one scene overflows
    assert (op[1].numpy()[3:, 0] == VT_VISUAL).any()


def test_batched_visual_scan_scenes_are_independent(visual_runs):
    """Each scene of the batch equals its own single-scene run."""
    arrs, ep0, _, (sp, op) = visual_runs
    cfg = VisualConfig(**VCFG)
    for s in range(S):
        st, out = visual_scan(
            cfg, map_tensors(lambda a: a[s], pmesh.new_batched_visual_state(
                S, T, 1, K, F, device=CPU)),
            *(torch.tensor(a[:, s]) for a in arrs), int(ep0[s]))
        assert torch.equal(out.track_id, op[0][:, s])
        assert torch.equal(out.voting_type, op[1][:, s])
        assert torch.equal(out.overflow, op[2][:, s])
        assert int(st.next_id) == int(sp.next_id[s])
        torch.testing.assert_close(st.kf.mean_pos, sp.kf.mean_pos[s],
                                   rtol=RTOL, atol=ATOL)


def test_batched_visual_step_matches_jax():
    """One step, with outputs beyond the scan's (slots, is_new, lengths,
    boxes)."""
    arrs = _visual_scenes()
    ep = np.array([4, 4, 9], np.int32)
    js = jmesh.new_batched_visual_state(S, T, 1, K, F)
    start = jax_state_dict(js)
    vstep = jax.jit(jmesh.batched_visual_step(JaxVisualConfig(**VCFG)))
    pstep = pmesh.batched_visual_step(VisualConfig(**VCFG))
    ps = visual_state_from_numpy(start, CPU)
    for i in range(3):
        js, oj = vstep(js, *(jnp.asarray(a[i]) for a in arrs),
                       jnp.asarray(ep + i))
        ps, op = pstep(ps, *(torch.tensor(a[i]) for a in arrs),
                       torch.tensor(ep + i))
    for name in ("slot", "track_id", "is_new", "length", "voting_type",
                 "overflow"):
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)), name)
    assert op.overflow.shape == (S,)
    assert_state_dicts_match(jax_state_dict(js), visual_state_to_numpy(ps))


SCFG = dict(method="iou", assignment="auction", max_idle_epochs=2,
            oriented=False, recycle_idle=True)


def test_batched_sort_step_and_scan_match_jax():
    arrs = _sort_scenes()
    ep0 = np.array([1, 1, 3], np.int32)
    js = jmesh.new_batched_state(S, T, 1)
    start = jax_state_dict(js)
    sj, (idj, ovj) = jax.jit(jmesh.batched_sort_scan(JaxSortConfig(**SCFG)))(
        js, *map(jnp.asarray, arrs), jnp.asarray(ep0))
    sp, (idp, ovp) = pmesh.batched_sort_scan(SortConfig(**SCFG))(
        sort_state_from_numpy(start, CPU), *map(torch.tensor, arrs),
        torch.tensor(ep0))
    np.testing.assert_array_equal(idp.numpy(), np.asarray(idj))
    np.testing.assert_array_equal(ovp.numpy(), np.asarray(ovj))
    assert_state_dicts_match(jax_state_dict(sj), sort_state_to_numpy(sp))
    assert ovp[:, 1].any() and not ovp[:, 0].any()
    # one step on the scanned states, all outputs
    jst, oj = jax.jit(jmesh.batched_sort_step(JaxSortConfig(**SCFG)))(
        sj, *(jnp.asarray(a[0]) for a in arrs), jnp.asarray(ep0 + N))
    pst, op = pmesh.batched_sort_step(SortConfig(**SCFG))(
        sp, *(torch.tensor(a[0]) for a in arrs), torch.tensor(ep0 + N))
    for name in ("slot", "track_id", "is_new", "length", "overflow"):
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)), name)
    # scene independence
    for s in range(S):
        _, out = sort_scan(SortConfig(**SCFG), map_tensors(
            lambda a: a[s], pmesh.new_batched_state(S, T, 1, device=CPU)),
            *(torch.tensor(a[:, s]) for a in arrs), int(ep0[s]))
        assert torch.equal(out.track_id, idp[:, s])


def test_geometry_and_kalman_take_a_scene_axis():
    """The positional pieces the batched steps reach give, scene by scene,
    what they give on one scene."""
    box, _, _ = oriented_stream(6, S, D, spread=60.0)  # one scene per row
    trk, _, _ = oriented_stream(7, S, T, spread=60.0)
    a, b = torch.tensor(box), torch.tensor(trk)
    spec = kal.KalmanSpec()
    kf = spec.predict(spec.initiate(b))
    batched = {
        "iou_oriented": geo.universal_iou_matrix(a, b, True),
        "iou_aligned": geo.universal_iou_matrix(a, b, False),
        "too_far": geo.too_far(a[:, :, None], b[:, None]),
        "dist_in_2r": geo.dist_in_2r(a[:, :, None], b[:, None]),
        "maha": spec.distance_matrix(kf, a),
    }
    for s in range(S):
        one = {
            "iou_oriented": geo.universal_iou_matrix(a[s], b[s], True),
            "iou_aligned": geo.universal_iou_matrix(a[s], b[s], False),
            "too_far": geo.too_far(a[s][:, None], b[s][None]),
            "dist_in_2r": geo.dist_in_2r(a[s][:, None], b[s][None]),
            "maha": spec.distance_matrix(map_tensors(lambda x: x[s], kf),
                                         a[s]),
        }
        for name, got in batched.items():
            for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (got, one[name]))):
                assert torch.equal(x[s], y), name
    assert batched["iou_oriented"][1].any()  # the boxes overlap
    assert geo.box_area(a).shape == (S, D)


@pytest.mark.parametrize("name,extra,history", [
    ("maha", dict(oriented=True), 1),
    ("constraints", {}, 1),
    ("euclid_iou", dict(oriented=True, own_area_use=0.4,
                        own_area_collect=0.6), 2)])
def test_batched_visual_scan_scenes_are_independent_in_other_configs(
        name, extra, history):
    """Mahalanobis on oriented boxes, constraints, and own-area gates with
    a deeper history: each scene of the batch equals its own run."""
    cfg = VisualConfig(**dict(VISUAL_CONFIGS[name], recycle_idle=True,
                              **extra))
    arrs = _visual_scenes()
    ep0 = np.array([2, 1, 4], np.int32)
    start = pmesh.new_batched_visual_state(S, T, history, K, F, device=CPU)
    sp, op = pmesh.batched_visual_scan(cfg)(
        start, *map(torch.tensor, arrs), torch.tensor(ep0))
    for s in range(S):
        st, out = visual_scan(cfg, map_tensors(lambda a: a[s], start),
                              *(torch.tensor(a[:, s]) for a in arrs),
                              int(ep0[s]))
        assert torch.equal(out.track_id, op[0][:, s])
        assert torch.equal(out.voting_type, op[1][:, s])
        assert torch.equal(out.overflow, op[2][:, s])
        assert torch.equal(st.hist_feat_valid, sp.hist_feat_valid[s])
        torch.testing.assert_close(st.kf.mean_pos, sp.kf.mean_pos[s],
                                   rtol=RTOL, atol=ATOL)
    assert (op[1].numpy()[3:] == VT_VISUAL).any()


def test_batched_sort_step_turns_the_sorted_path_off():
    """The batched step once turned the sorted path off; now, with
    oriented_block_sort=True, it keeps it: one clip call over both scenes
    a step and no dense oriented IoU, and two identical scenes get
    identical results (each scene against the single-scene step:
    tests/test_torch_oriented_batched.py)."""
    from similari_tpu_torch.utils import profiling

    cfg = SortConfig(method="iou", oriented=True, oriented_block_sort=True,
                     assignment="auction")
    box, conf, valid = oriented_stream(3, 1, 64, spread=2500.0)
    st = pmesh.new_batched_state(2, 512, 1, device=CPU)
    args = [torch.tensor(np.stack([x[0]] * 2)) for x in (box, conf, valid)]
    def clip_calls():
        return profiling.summary()["spans"].get(
            "sort_step.clip", {"calls": 0})["calls"]

    dense, clips = profiling.counter("geometry.oriented_dense"), clip_calls()
    bst, out = pmesh.batched_sort_step(cfg)(st, *args, torch.tensor([1, 1]))
    assert profiling.counter("geometry.oriented_dense") == dense
    assert clip_calls() == clips + 1
    assert out.track_id.shape == (2, 64)
    assert torch.equal(out.track_id[0], out.track_id[1])
    assert torch.equal(out.slot[0], out.slot[1])
    assert torch.equal(bst.kf.mean_pos[0], bst.kf.mean_pos[1])


# --------------------------------------------------------------------------
# the in-place batched step against the plain batched step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_inplace_step_matches_plain_step(dtype):
    """From copies of one start state; the in-place form overwrites its
    input state's feature arrays."""
    cfg = VisualConfig(**dict(VCFG, feature_precision="f32"))
    arrs = _visual_scenes()
    ref = pmesh.new_batched_visual_state(S, T, 2, K, F, dtype, device=CPU)
    alt = map_tensors(torch.clone, ref)
    vstep = pmesh.batched_visual_step(cfg)
    istep = pmesh.batched_visual_step_inplace(cfg)
    for i in range(N):
        args = [torch.tensor(a[i]) for a in arrs]
        ep = torch.full((S,), i + 1)
        before = alt.feats
        ref, out_r = vstep(ref, *args, ep)
        alt, out_i = istep(alt, *args, ep)
        assert alt.feats is before  # written in place
        for name in ("track_id", "voting_type", "is_new", "overflow"):
            assert torch.equal(getattr(out_r, name), getattr(out_i, name))
    for f in dataclasses.fields(ref):
        if f.name != "kf":
            assert torch.equal(getattr(ref, f.name), getattr(alt, f.name)), \
                f.name
    assert alt.feats.dtype == dtype and (out_i.voting_type == VT_VISUAL).any()


def test_batched_states_round_trip_through_numpy():
    st = pmesh.new_batched_visual_state(S, T, 2, K, F, torch.bfloat16,
                                        device=CPU)
    st = dataclasses.replace(st, feats=torch.randn(st.feats.shape).bfloat16(),
                             next_id=torch.tensor([3, 0, 7],
                                                  dtype=torch.int32))
    back = visual_state_from_numpy(visual_state_to_numpy(st), CPU,
                                   torch.bfloat16)
    for f in dataclasses.fields(st):
        if f.name != "kf":
            assert torch.equal(getattr(back, f.name), getattr(st, f.name))
    sst = pmesh.new_batched_state(S, T, 1, device=CPU)
    back = sort_state_from_numpy(sort_state_to_numpy(sst), CPU)
    assert back.next_id.shape == (S,) and back.kf.cvv.shape == (S, T, 5)
