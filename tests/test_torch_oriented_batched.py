"""Oriented SORT batched over scenes on the sorted clip path
(`trackers/sort_step.py::_match_sorted` with a scene axis,
`ops/clip.py::clip_pairs` over [S, D, 8] x [S, T, 8]), on the CPU through
the clip's plain version: each scene as the single-scene sorted path, the
whole against the plain float64 oracle `reference_oriented_torch.py` on
the oriented cell's traffic model, the batched plain clip bit-equal to
per-scene calls, and the oracle's rotated IoU against
`reference_sort.py::poly_iou`."""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from similari_tpu_torch.ops import clip as cl
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_step
from similari_tpu_torch.trackers.state import map_tensors
from similari_tpu_torch.utils import profiling

import reference_oriented_torch as ref
import reference_sort
from torch_parity import oriented_stream, random_boxes

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG = SortConfig(method="iou", iou_threshold=0.3, min_confidence=0.05,
                 max_idle_epochs=5, assignment="auction", oriented=True,
                 recycle_idle=True, oriented_block_sort=True)
STATE_FIELDS = ("active", "last_epoch", "length", "track_id", "next_id",
                "pred_box", "obs_box", "conf")


def test_batched_sorted_path_is_each_scene_alone():
    """S=3 scenes of D=64 rows and T=512 slots, the sorted path's gate:
    ids, slots, is_new and the final state of each scene equal to the
    single-scene sorted step's, with one clip call a step and no dense
    oriented IoU."""
    s, n = 3, 8
    streams = [oriented_stream(40 + j, n, 64, spread=900.0) for j in range(s)]
    box, conf, valid = (torch.tensor(np.stack(x, 1)) for x in zip(*streams))
    step = pmesh.batched_sort_step(CFG)
    st = pmesh.new_batched_state(s, 512, 1, device=CPU)
    one = [map_tensors(lambda a: a[j].clone(), st) for j in range(s)]
    dense = profiling.counter("geometry.oriented_dense")
    for i in range(n):
        ep = torch.full((s,), i + 1, dtype=torch.int32)
        st, out = step(st, box[i], conf[i], valid[i], ep)
        for j in range(s):
            one[j], o = sort_step(CFG, one[j], box[i, j], conf[i, j],
                                  valid[i, j], i + 1)
            for f in ("slot", "track_id", "is_new", "length", "overflow"):
                assert torch.equal(getattr(o, f), getattr(out, f)[j]), (i, f)
            assert torch.equal(o.pred_box, out.pred_box[j])
    assert profiling.counter("geometry.oriented_dense") == dense
    for j in range(s):
        for f in STATE_FIELDS:
            assert torch.equal(getattr(one[j], f), getattr(st, f)[j]), f
        for f in dataclasses.fields(one[j].kf):
            assert torch.equal(getattr(one[j].kf, f.name),
                               getattr(st.kf, f.name)[j]), f.name


def _oriented_frames(scenes, frames, seed):
    """Frames of the oriented cell's traffic model cut small: 40-56
    rotated vehicles a scene in 1920 x 1080, rows padded to 64."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    from perfbench.traffic_oriented import OrientedScenes

    mix = dict(harness.load_cell("sort_obb500_stream_s128").mix,
               population=[40, 56], dpad=64)
    gen = OrientedScenes(mix, scenes, seed, CPU)
    return [gen.step() for _ in range(frames)]


def test_port_equals_the_oriented_reference():
    """48 frames of 2 scenes through the batched sorted step, each frame
    held to the float64 oracle: ids, slots and new-track flags equal (the
    auction's result taken where it is an equal optimum), Kalman boxes
    within 2e-4 of the largest, the final state equal."""
    s, n, cap = 2, 48, 512
    frames = _oriented_frames(s, n, 2**31 + 3)
    step = pmesh.batched_sort_step(CFG)
    st = pmesh.new_batched_state(s, cap, 1, device=CPU)
    refs = [ref.OrientedSort(cap, 64) for _ in range(s)]
    rows = 0
    for i, fr in enumerate(frames):
        ep = torch.full((s,), i + 1, dtype=torch.int32)
        st, out = step(st, fr.box, fr.conf, fr.valid, ep)
        assert not out.overflow.any()
        for j in range(s):
            v = fr.valid[j]
            r = refs[j].step(fr.box[j], fr.conf[j], v, i + 1,
                             dict(slots=out.slot[j], is_new=out.is_new[j]))
            assert r["refused"] == 0, (i, j)
            assert torch.equal(out.track_id[j][v].long(), r["ids"][v]), (i, j)
            assert torch.equal(out.slot[j][v].long(), r["slots"][v])
            assert torch.equal(out.is_new[j][v], r["is_new"][v])
            scale = float(r["pred"][v].abs().max())
            err = float((out.pred_box[j][v].double() - r["pred"][v]).abs().max())
            assert err <= 2e-4 * scale
            rows += int(v.sum())
    assert rows > 40 * n * s
    for j in range(s):
        want = refs[j].state()
        act = want["active"]
        assert torch.equal(st.active[j], act)
        for f in ("last_epoch", "length", "track_id"):
            assert torch.equal(getattr(st, f)[j][act].long(), want[f][act]), f
        assert int(st.next_id[j]) == refs[j].next_id
        for f in ("mean_pos", "mean_vel", "cpp", "cpv", "cvv"):
            got = getattr(st.kf, f)[j][act].double()
            assert float((got - want[f][act]).abs().max()) <= 2e-4 * max(
                float(want[f][act].abs().max()), 1e-30), f


@pytest.mark.parametrize("want_iou", [True, False])
def test_batched_plain_clip_is_per_scene_calls_bit_for_bit(want_iou):
    rng = np.random.default_rng(9)
    s, d, t = 4, 37, 70
    det = torch.tensor(np.stack([random_boxes(rng, d, 300.0)
                                 for _ in range(s)]))
    trk = torch.tensor(np.stack([random_boxes(rng, t, 300.0)
                                 for _ in range(s)]))
    det[1] = 0.0  # a scene of padding
    det8, trk8 = cl.clip_columns(det), cl.clip_columns(trk)
    tiles = torch.zeros(1, dtype=torch.int32)
    got = cl.clip_pairs(det8, trk8, want_iou, tiles)
    assert got.shape == (s, d, t)
    one = torch.zeros(1, dtype=torch.int32)
    for j in range(s):
        want = cl.clip_pairs(det8[j], trk8[j], want_iou, one)
        assert torch.equal(got[j], want), j
        assert torch.equal(want, cl.pair_block_plain(det8[j], trk8[j],
                                                     want_iou))
    assert int(tiles) == int(one) > 0
    assert torch.equal(got, cl.pair_block_plain(det8, trk8, want_iou))
    with pytest.raises(ValueError, match="same scenes"):
        cl.clip_pairs(det8, trk8[:2], want_iou)


def _pairs(kind, rng, n=40):
    """(a, b) boxes [n, 5] float64 of one kind of pair."""
    a = random_boxes(rng, n, 200.0).astype(np.float64)
    if kind == "random":
        b = a.copy()
        b[:, :2] += rng.uniform(-30, 30, (n, 2))
        b[:, 2] = rng.uniform(0, 2 * np.pi, n)
        b[:, 3:] *= rng.uniform(0.6, 1.5, (n, 2))
    elif kind == "identical":
        b = a.copy()
    elif kind == "nested":
        b = a.copy()
        b[:, 2] += rng.uniform(-0.3, 0.3, n)
        b[:, 4] *= 0.4  # a smaller box about the same centre
    elif kind == "touching":
        # b shares a's right edge, same angle: a line, no area
        b = a.copy()
        w = a[:, 3] * a[:, 4]
        b[:, 0] += w * np.cos(a[:, 2])
        b[:, 1] += w * np.sin(a[:, 2])
        b[:8, 2] = 0.0  # and some aligned pairs on exact coordinates
        a[:8, 2] = 0.0
        a[:8, :2] = np.round(a[:8, :2])
        a[:8, 3:] = [[1.0, 20.0]]
        b[:8, :2] = a[:8, :2] + [[20.0, 0.0]]
        b[:8, 3:] = [[1.0, 20.0]]
    else:
        raise KeyError(kind)
    return a, b


@pytest.mark.parametrize("kind", ["random", "identical", "nested", "touching"])
def test_oracle_rotated_iou_equals_poly_iou(kind):
    a, b = _pairs(kind, np.random.default_rng(len(kind)))
    got = ref.rotated_iou(torch.tensor(a), torch.tensor(b)).diagonal().numpy()
    want = np.array([reference_sort.poly_iou(x, y) for x, y in zip(a, b)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if kind == "identical":
        np.testing.assert_allclose(got, 1.0, rtol=0, atol=1e-9)
    if kind == "nested":
        assert (got > 0.05).all()
    if kind == "touching":
        assert np.abs(got).max() <= 1e-9
        assert (got[:8] == 0.0).all()
    if kind == "random":
        assert (got > 0).sum() > len(got) // 2
    assert math.isfinite(float(np.abs(got).max()))
