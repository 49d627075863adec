"""The oriented cell (`sort_obb500_stream_s128`) and the sparse-feature
cell (`vsort512_sparsefeat_s1024`) cut to a size the CPU runs in seconds:
both come out correct against their references, each planted fault turns
`correct` false, and the traffic, the work count and the new readers keep
to what they say."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, work_oriented
from perfbench.reference import check as chk

from cells import CPU, correct

SEED = 2**32 + 101
# the oriented cell keeps its shapes' gates (T >= 512, D >= 64), so the
# CPU steps on the sorted path the card takes, through the clip's plain
# version
TINY = {
    "sort_obb500_stream_s128": dict(scenes=2, check_scenes=2, warm_frames=2,
                                    population=[40, 56], dpad=64,
                                    capacity=512),
    "vsort512_sparsefeat_s1024": dict(scenes=3, check_scenes=2,
                                      warm_frames=2),
}


def tiny_cell(name):
    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, **TINY[name])
    if "obb" in name:
        cell.config = dict(cell.config, settings=dict(
            cell.config["settings"], oriented_block_sort=True))
    return cell


def run_tiny(name, seed, control=None, seconds=1.0, trace=False):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    drv = harness.driver(cell).Driver(cell, seed, CPU, control)
    drv.setup()
    if trace:
        counts = []
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                drv._step(counts)
    run = drv.window(seconds, False)
    readings = drv.check()
    return chk.numbers(readings, cell.visual), cell.mix["limits"], run, drv


@pytest.mark.parametrize("name", sorted(TINY))
def test_new_cell_on_the_cpu_equals_the_reference(name):
    nums, limits, run, _ = run_tiny(name, SEED)
    assert correct(nums, limits), nums
    assert nums["mismatches"] == 0
    assert run["frames"] > 0 and run["failed"] == 0


@pytest.mark.parametrize("control", ["program_aligned", "reference_bf16_boxes"])
def test_planted_fault_is_not_correct(control):
    nums, limits, _, _ = run_tiny("sort_obb500_stream_s128", SEED + 1, control)
    assert not correct(nums, limits), nums


def test_oriented_traffic_keeps_each_heading_and_shape():
    from perfbench.traffic_oriented import OrientedScenes

    mix = dict(harness.load_cell("sort_obb500_stream_s128").mix, scenes=3)
    g = OrientedScenes(mix, 3, SEED, CPU)
    lo, hi = mix["heading"]
    assert ((g.heading >= lo) & (g.heading <= hi)).all()
    h, w = g.wh[..., 1], g.wh[..., 0]
    assert ((h >= 12) & (h <= 28)).all()
    assert ((w / h >= 1.8 - 1e-5) & (w / h <= 2.6 + 1e-5)).all()
    fr = g.step()
    own = fr.src >= 0
    truth = g.heading[g.perm].gather(1, fr.src.clamp(min=0))
    noise = (fr.box[..., 2] - truth)[own]
    assert noise.abs().max() < 8 * mix["angle_noise"]
    assert 0.5 * mix["angle_noise"] < noise.std() < 2 * mix["angle_noise"]
    assert (fr.box[..., 2][fr.src == -2] == 0).all()
    fp = fr.box[..., 2][fr.src == -1]
    assert ((fp >= lo) & (fp <= hi)).all() and abs(hi) < math.pi / 2
    again = OrientedScenes(mix, 3, SEED, CPU).step()
    assert torch.equal(again.box, fr.box)


def test_oriented_scenes_do_the_same_work_for_every_seed():
    """`--seed` orders the scenes and nothing else: a scene's frames,
    headings and noise included, are the same in every run."""
    from perfbench.traffic_oriented import OrientedScenes

    mix = harness.load_cell("sort_obb500_stream_s128").mix
    a = OrientedScenes(mix, 5, SEED, CPU)
    b = OrientedScenes(mix, 5, SEED + 7, CPU)
    assert not torch.equal(a.perm, b.perm)
    ia, ib = torch.argsort(a.perm), torch.argsort(b.perm)
    for _ in range(3):
        fa, fb = a.step(), b.step()
        for k in ("box", "conf", "valid", "src"):
            assert torch.equal(getattr(fa, k)[ia], getattr(fb, k)[ib]), k


def test_sparse_features_come_on_one_frame_in_five_a_scene():
    from perfbench.drivers.stream_sparse import SparseScenes

    mix = harness.load_cell("vsort512_sparsefeat_s1024").mix
    g = SparseScenes(mix, 7, SEED, CPU, feature_dim=4)
    for epoch in range(1, 11):
        fr = g.step()
        on = fr.fvalid.any(1)
        want = (epoch + torch.arange(7)) % mix["feature_every"] == 0
        assert torch.equal(on, want & fr.valid.any(1))
        assert torch.equal(fr.fvalid[want], fr.valid[want])


def test_in_radius_pairs_count_what_the_clip_sees():
    from similari_tpu_torch.ops import clip as cl

    g = torch.Generator().manual_seed(5)
    det = torch.rand((2, 40, 5), generator=g) * torch.tensor(
        [200.0, 200.0, 1.0, 2.0, 30.0]) + torch.tensor([0, 0, -0.5, 1, 10])
    trk = det[:, torch.randperm(40, generator=g)] + 3.0
    trk[..., 2:] = det[..., 2:]
    valid = torch.rand((2, 40), generator=g) > 0.2
    alive = torch.rand((2, 40), generator=g) > 0.3
    pairs, nv, na = work_oriented.in_radius_pairs(det, valid, trk, alive)
    for k in range(2):
        near = ~cl.far_pairs(cl.clip_columns(det[k]), cl.clip_columns(trk[k]))
        assert int(pairs[k]) == int((near & valid[k][:, None]
                                     & alive[k][None]).sum())
    assert torch.equal(nv, valid.sum(1)) and torch.equal(na, alive.sum(1))
    ops, nbytes = work_oriented.clip_work(pairs.numpy(), nv.numpy(),
                                          na.numpy())
    p = float(pairs.sum())
    assert ops == work_oriented.CLIP_OPS * p
    assert nbytes == 32.0 * float(nv.sum() + na.sum()) + 4.0 * p


def _read(name, run):
    return harness.load_module(harness.HERE / "metrics"
                               / f"{name}.py").read(run)


NEW = ("clip_roofline.obb", "clip_tile_share.obb", "auction_rounds.obb")


def test_new_readers_read_a_tiny_traced_oriented_run():
    from similari_tpu_torch.utils import profiling

    profiling.reset()
    try:
        _, _, run, _ = run_tiny("sort_obb500_stream_s128", SEED + 2,
                                seconds=0.5, trace=True)
        kept = profiling.summary()["kept"]
        # one launch a step, kept only for the three profiled steps
        assert kept["clip.tiles_run"]["rows"] == kept["clip.tiles"]["rows"] == 3
        share = _read("clip_tile_share.obb", run)
        assert 0.0 < share < 100.0
        ran, tiles = kept["clip.tiles_run"]["sum"][0], kept["clip.tiles"]["sum"][0]
        assert share == pytest.approx(100.0 * ran / tiles)
        spans = profiling.summary()["spans"]
        steps = spans["batched_sort_step"]["calls"]
        rounds = profiling.counter("auction.rounds")
        assert _read("auction_rounds.obb", run) == rounds / steps >= 3.0
        for name in ("sort_step.sort_scenes", "sort_step.clip",
                     "sort_step.unsort"):
            assert spans[name]["calls"] == steps, name
        assert profiling.counter("geometry.oriented_dense") == 0
        # no device profile on the CPU; the three steps' pairs counted
        assert _read("clip_roofline.obb", run) is None
        assert len(run["pairs"]) == 3
        assert all(len(x) == 3 and x[0].shape == (2,) for x in run["pairs"])
    finally:
        profiling.reset()


def test_new_readers_give_none_without_records(monkeypatch):
    from similari_tpu_torch.utils import profiling

    profiling.reset()
    assert all(_read(name, {}) is None for name in NEW)
    monkeypatch.delattr(profiling, "summary")
    assert all(_read(name, {}) is None for name in NEW)


def test_clip_roofline_counts_the_traced_pairs():
    prof = harness.Profile(window_s=1.0, busy_s=0.5,
                           kernels={"clip_pairs_kernel<true>": (1e-3, 2)},
                           span_busy_s={}, device_ops=[], idle_gaps=[])
    pairs = [(np.array([1000, 2000]), np.array([500, 520]),
              np.array([600, 610]))] * 2
    ops, nbytes = work_oriented.clip_work(*map(np.concatenate, zip(*pairs)))
    from perfbench import peaks
    least, _ = peaks.least_time(ops, nbytes)
    assert _read("clip_roofline.obb", {"profile": prof, "pairs": pairs}) \
        == pytest.approx(100.0 * least / 1e-3)


def test_traced_pairs_are_counted_scenes_a_chunk_at_a_time():
    """The oriented driver counts the traced steps' pairs after the
    window a few scenes at a time: the same counts as one whole call."""
    drv = harness.load_module(harness.HERE / "drivers" / "stream_oriented.py")
    g = torch.Generator().manual_seed(5)
    s, d, t = 5, 40, 70

    def boxes(n):
        b = torch.rand((s, n, 5), generator=g) * torch.tensor(
            [300.0, 200.0, 3.0, 1.0, 20.0]) + torch.tensor(
            [0.0, 0.0, -1.5, 1.8, 8.0])
        return b

    det, trk = boxes(d), boxes(t)
    valid = torch.rand((s, d), generator=g) < 0.8
    alive = torch.rand((s, t), generator=g) < 0.6
    whole = work_oriented.in_radius_pairs(det, valid, trk, alive)
    got = drv._pairs(det, valid, trk, alive, chunk=2)
    assert whole[0].sum() > 0
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("before, after, ok", [
    ({"counts": {"clip.launches": 3}}, {"counts": {"clip.launches": 4}}, True),
    ({"counts": {}}, {"counts": {"clip.launches": 1}}, True),
    ({"counts": {"clip.launches": 3}}, {"counts": {"clip.launches": 3}}, False),
    ({"counts": {}}, {"counts": {}}, False),
    (None, None, False),
])
def test_oriented_cell_requires_the_clip_launch(before, after, ok):
    """A port whose first oriented step launches no clip kernel (or keeps
    no counts) ends the run with exit code 1 and no result."""
    drv = harness.load_module(harness.HERE / "drivers" / "stream_oriented.py")
    if ok:
        drv.require_clip_launch(before, after)
    else:
        with pytest.raises(SystemExit) as e:
            drv.require_clip_launch(before, after)
        assert e.value.code == 1
