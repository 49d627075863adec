"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
neither JAX nor the JAX package, so on a machine without JAX they run
without the JAX-configuring tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The small streams cover what the full-width check in chip_smoke.py does
not reach: overflow with and without recycling, all-zero padded rows,
large-norm identities, every gallery configuration, and crowded scenes
for the auction at every positional kind; for the clip kernel, identical,
touching, degenerate and far-apart boxes and ragged shapes, the sorted
SORT path and block-skip NMS; for the merge kernel, every dtype, odd
widths, invalid and out-of-range rows, and the in-place batched step.
Integer outputs and state must be equal; floats are held at
torch_parity.RTOL/ATOL; the merge kernel is a copy and must be bit-equal.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from similari_tpu_torch import _build
from similari_tpu_torch.ops import assignment as asg
from similari_tpu_torch.ops import clip as cl
from similari_tpu_torch.ops import fused_sort as fs
from similari_tpu_torch.ops import fused_visual as fv
from similari_tpu_torch.ops import gallery_dots as gd
from similari_tpu_torch.ops import merge_inplace as mi
from similari_tpu_torch.ops import visual_votes as vv
from similari_tpu_torch.ops.nms import nms_kernel
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan
from similari_tpu_torch.trackers.state import map_tensors, new_sort_state
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import VT_VISUAL, VisualConfig
from similari_tpu_torch.utils import profiling

from torch_parity import (ATOL, AUCTION_CASES, EXACT_BOX_COLUMNS, RAW_CASES,
                          RAW_ROUNDS, RTOL, VISUAL_CONFIGS, VOTE_CASES,
                          auction_inputs, crowded_stream, large_norm_stream,
                          oriented_stream, random_boxes, sort_overflow_stream,
                          sort_stream, tracking_weights,
                          visual_overflow_stream, visual_padded_stream,
                          visual_stream, votes_args, votes_inputs)

pytestmark = pytest.mark.cuda
CHUNK = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_same(kernel, plain):
    for a, b in zip(kernel, plain):
        if isinstance(a, (tuple, list)):
            _assert_same(a, b)
        elif a.dtype in (torch.bool, torch.int32):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def _chunks(fn, cfg, st, inputs, steps):
    outs = []
    for c0 in range(0, steps, CHUNK):
        st, *o = fn(cfg, st, *(x[c0:c0 + CHUNK] for x in inputs), 1 + c0)
        outs.append(o)
    return st, [torch.cat(x) for x in zip(*outs)]


def _unit_conf(box, valid):
    return box, np.ones(valid.shape, np.float32), valid


def _padded_frames():
    """Random-walk rows with two frames of padding only."""
    box, valid = sort_stream(4, 8, 16)
    valid[2] = False
    valid[5] = False
    return _unit_conf(box, valid)


def _walk(seed, steps, d, spread):
    box, valid = sort_stream(seed, steps, d, density=spread)
    box[..., 3] = np.random.default_rng(seed).uniform(0.5, 1.5, (steps, d))
    return box, np.random.default_rng(seed + 1).uniform(
        0.4, 1.0, (steps, d)).astype(np.float32), valid


# name: (config, stream, capacity T, `fused_sort_chunk.plan["storage"]`
# or None)
SORT_CASES = {
    "stream": (dict(), lambda: _unit_conf(*sort_stream(0, 8, 8)), 32, None),
    "overflow": (dict(max_idle_epochs=2),
                 lambda: _unit_conf(*sort_overflow_stream(8, 8)), 8, None),
    "overflow_recycle": (dict(max_idle_epochs=2, recycle_idle=True),
                         lambda: _unit_conf(*sort_overflow_stream(8, 8)), 8,
                         None),
    # several auction rounds per frame, equal bids from an exact copy
    "crowded": (dict(recycle_idle=True),
                lambda: crowded_stream(0, 8, 16, 12, 16, 133.0,
                                       copies=1)[:3], 64, None),
    "padded_frames": (dict(), _padded_frames, 64, None),
    # D in {1, 128, 1024} against T in {200, 500, 512, 2000, 4000, 8000}:
    # ragged column slices, and each storage of a block's data
    "d1_t200": (dict(), lambda: _walk(1, 8, 1, 50.0), 200, 7),
    "d1_t500": (dict(), lambda: _walk(2, 8, 1, 50.0), 500, 7),
    "d128_t200": (dict(recycle_idle=True), lambda: crowded_stream(
        1, 8, 128, 100, 16, 400.0)[:3], 200, 7),
    "d128_t500": (dict(), lambda: crowded_stream(2, 8, 128, 100, 16,
                                                 400.0)[:3], 500, 7),
    "d128_t512": (dict(), lambda: _walk(3, 8, 128, 1000.0), 512, 7),
    "d128_t2000": (dict(), lambda: _walk(4, 8, 128, 1000.0), 2000, 7),
    "d1024_t512": (dict(max_idle_epochs=1), lambda: _walk(5, 8, 1024,
                                                          3000.0), 512, 6),
    "d1024_t2000": (dict(), lambda: _walk(6, 4, 1024, 3000.0), 2000, 6),
    "d1024_t4000": (dict(), lambda: _walk(7, 4, 1024, 3000.0), 4000, 4),
    "d1024_t8000": (dict(), lambda: _walk(8, 4, 1024, 3000.0), 8000, 0),
    # contested columns with a ragged T
    "d64_t300_crowded": (dict(recycle_idle=True), lambda: crowded_stream(
        3, 8, 64, 40, 16, 250.0)[:3], 300, 7),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_fused_sort_kernel_matches_plain(cuda, case):
    """One cluster of 8 blocks; a block's column arrays, state slice and W
    slice in shared memory where they fit, else in device memory, as
    `storage` says."""
    kw, make, t, storage = SORT_CASES[case]
    cfg = SortConfig(method="iou", oriented=False, **dict(
        dict(max_idle_epochs=5), **kw))
    inputs = [torch.tensor(x, device=cuda) for x in make()]
    steps = len(inputs[0])
    st = fs.state_to_tuple(new_sort_state(t, 1, device=cuda))
    before = profiling.counter("fused_sort.launches")
    k = _chunks(fs.fused_sort_chunk, cfg, st, inputs, steps)
    assert profiling.counter("fused_sort.launches") == before + steps // CHUNK
    assert (fs.fused_sort_chunk.plan["cluster"],
            fs.fused_sort_chunk.plan["threads"]) == (8, 512)
    if storage is not None:
        assert fs.fused_sort_chunk.plan["storage"] == storage
    p = _chunks(fs.fused_sort_chunk_plain, cfg, st, inputs, steps)
    _assert_same(k, p)


def test_fused_sort_phase_stamps(cuda):
    """A profiled launch stamps every phase in order and counts the
    cluster barriers: two per frame, one per auction round."""
    cfg = SortConfig(method="iou", oriented=False)
    box, conf, valid = (torch.tensor(x, device=cuda)
                        for x in crowded_stream(0, CHUNK, 16, 12, 16, 133.0,
                                                copies=1)[:3])
    st = fs.state_to_tuple(new_sort_state(64, 1, device=cuda))
    prof = torch.zeros((CHUNK, fs.PROF_WIDTH), dtype=torch.int64,
                       device=cuda)
    stats = fs.fused_sort_chunk(cfg, st, box, conf, valid, 1, prof=prof)[5]
    prof = prof.cpu()
    stamps = prof[:, :len(fs.PHASES) + 1]
    assert bool((stamps[:, 1:] >= stamps[:, :-1]).all())
    assert torch.equal(prof[:, -1], 2 + stats[:, 0].cpu().long())


def _visual_walk(seed, steps, d, n, f, spread):
    """n crowded random-walk objects in rows 0..n-1 of d, the rest
    padding (all-zero, invalid)."""
    out = []
    for x in crowded_stream(seed, steps, n, n, f, spread, copies=0):
        pad = np.zeros((steps, d - n) + x.shape[2:], x.dtype)
        out.append(np.concatenate([x, pad], axis=1))
    return out


def _all_padded_frames():
    """`visual_stream` with two frames of padding only."""
    stream = list(visual_stream(2, 8, 8, 16))
    stream[2][2] = False
    stream[2][5] = False
    return stream


MAIN = dict(VISUAL_CONFIGS["cosine_gates"], feature_precision="bf16")

# name: (config, stream, capacity T, `fused_visual_chunk.plan["storage"]`
# or None)
VISUAL_CASES = {
    **{name: (kw, lambda: visual_stream(0, 8, 8, 16), 32, None)
       for name, kw in VISUAL_CONFIGS.items()},
    "bf16": (dict(VISUAL_CONFIGS["euclid_iou"], feature_precision="bf16"),
             lambda: visual_stream(1, 8, 8, 16), 32, None),
    "overflow": (dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=2),
                 lambda: visual_overflow_stream(8, 8, 16), 8, None),
    "overflow_recycle": (dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=2,
                              recycle_idle=True),
                         lambda: visual_overflow_stream(8, 8, 16), 8, None),
    "padded": (dict(VISUAL_CONFIGS["cosine_gates"], feature_precision="bf16"),
               lambda: visual_padded_stream(12, 16, 16), 64, None),
    "all_padded_frames": (VISUAL_CONFIGS["euclid_iou"], _all_padded_frames,
                          32, None),
    "large_norm": (dict(VISUAL_CONFIGS["euclid_iou"], visual_threshold=1e4,
                        visual_minimal_track_length=1),
                   lambda: large_norm_stream(8, 8, 16), 32, None),
    **{f"crowded_{name}": (VISUAL_CONFIGS[name], lambda: crowded_stream(
        0, 8, 16, 12, 16, 133.0, noise=2.0, copies=1), 64, None)
       for name in ("euclid_iou", "maha", "constraints")},
    # D in {1, 128, 1024} against T not a multiple of the cluster: each
    # storage of a block's data; T=2573 is the most slots the one-block
    # kernel took at D=128, K=3
    "d1_t500": (VISUAL_CONFIGS["euclid_iou"],
                lambda: _visual_walk(1, 8, 1, 1, 16, 50.0), 500, 7),
    "d128_t500": (MAIN, lambda: _visual_walk(2, 8, 128, 100, 16, 1000.0),
                  500, 7),
    "d128_t2573": (MAIN, lambda: _visual_walk(3, 8, 128, 100, 16, 1000.0),
                   2573, 6),
    "d128_t8000": (dict(MAIN, recycle_idle=True), lambda: _visual_walk(
        4, 8, 128, 100, 16, 1000.0), 8000, 4),
    "d128_t11000": (MAIN, lambda: _visual_walk(5, 4, 128, 100, 16, 1000.0),
                    11000, 2),
    "d128_t14000": (MAIN, lambda: _visual_walk(11, 4, 128, 100, 16, 1000.0),
                    14000, 0),
    "d1024_t20": (VISUAL_CONFIGS["euclid_iou"], lambda: _visual_walk(
        6, 4, 1024, 16, 16, 400.0), 20, 7),
    "d1024_t700": (dict(MAIN, recycle_idle=True), lambda: _visual_walk(
        7, 4, 1024, 400, 16, 3000.0), 700, 6),
    "d1024_t1500": (MAIN, lambda: _visual_walk(8, 4, 1024, 400, 16, 3000.0),
                    1500, 4),
    "d1024_t2000": (MAIN, lambda: _visual_walk(9, 4, 1024, 400, 16, 3000.0),
                    2000, 2),
    "d1024_t4000": (VISUAL_CONFIGS["maha"], lambda: _visual_walk(
        10, 4, 1024, 400, 16, 3000.0), 4000, 0),
}


@pytest.mark.parametrize("case", sorted(VISUAL_CASES))
def test_fused_visual_kernel_matches_plain(cuda, case):
    """One cluster of VISUAL_CLUSTER blocks; a block's column arrays, state
    slice and [D, Tc] matrices in shared memory where they fit, else in
    device memory, as `storage` says."""
    kw, make, t, storage = VISUAL_CASES[case]
    cfg = VisualConfig(**kw)
    stream = make()
    inputs = [torch.tensor(x, device=cuda) for x in stream]
    st = fv.state_to_tuple(new_visual_state(t, 1, 3, stream[3].shape[2],
                                            device=cuda))
    before = profiling.counter("gallery_dots.launches")
    k = _chunks(fv.fused_visual_chunk, cfg, st, inputs, len(stream[0]))
    assert (profiling.counter("gallery_dots.launches")
            == before + len(stream[0]) // CHUNK)
    assert (fv.fused_visual_chunk.plan["cluster"],
            fv.fused_visual_chunk.plan["threads"]) == (
                fv.VISUAL_CLUSTER, fv.VISUAL_THREADS)
    if storage is not None:
        assert fv.fused_visual_chunk.plan["storage"] == storage
    p = _chunks(fv.fused_visual_chunk_plain, cfg, st, inputs, len(stream[0]))
    _assert_same(k, p)


def test_fused_visual_phase_stamps(cuda):
    """A profiled launch stamps every phase in order and counts the
    cluster barriers: four per frame (the max distance, the argmaxes, the
    span, the match flags), one per auction round."""
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    inputs = [torch.tensor(x, device=cuda) for x in crowded_stream(
        0, CHUNK, 16, 12, 16, 133.0, noise=2.0, copies=1)]
    st = fv.state_to_tuple(new_visual_state(64, 1, 3, 16, device=cuda))
    prof = torch.zeros((CHUNK, fv.PROF_WIDTH), dtype=torch.int64,
                       device=cuda)
    stats = fv.fused_visual_chunk(cfg, st, *inputs, 1, prof=prof)[8]
    prof = prof.cpu()
    stamps = prof[:, :len(fv.PHASES) + 1]
    assert bool((stamps[:, 1:] >= stamps[:, :-1]).all())
    assert torch.equal(prof[:, -1], 4 + stats[:, 0].cpu().long())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m", [70, 1536])
@pytest.mark.parametrize("f", [3, 16, 129, 512])
def test_gallery_dots_kernel_matches_plain(cuda, f, m, bf16):
    """Every entry the scan reads (all launch-start lanes, chunk rows of
    earlier frames) within rtol 1e-5 and 1e-4 x |q| |g| of the plain
    product; the norms of the unrounded rows within 1e-5.  N = 120 rows
    are ragged against the 192 x 256 (bf16) and 64 x 64 (f32) tiles, and
    M + N = 190 or 1656 columns; F = 3 and 129 take the scalar copies and
    pad the bf16 copy to 64 and 192 columns."""
    g = torch.Generator().manual_seed(f)
    c, d = 5, 24
    x = torch.randn((c * d, f), generator=g).to(cuda)
    gal = (3.0 * torch.randn((m, f), generator=g)).to(cuda)
    before = profiling.counter("gallery_dots.launches")
    dots, norms = gd.gallery_dots(x, gal, bf16, d)
    assert profiling.counter("gallery_dots.launches") == before + 1
    p_dots, p_norms = gd.gallery_dots_plain(x, gal, bf16)
    torch.cuda.synchronize()
    need = gd.needed_columns(c * d, m, d, cuda)
    cols = torch.cat([gal, x])
    scale = x.norm(dim=1)[:, None] * cols.norm(dim=1)[None, :]
    err = (dots - p_dots).abs()
    assert bool((err <= 1e-5 * p_dots.abs() + 1e-4 * scale)[need].all())
    torch.testing.assert_close(norms, p_norms, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_checks_inputs(cuda):
    cfg = SortConfig(method="iou", oriented=False)
    st = fs.state_to_tuple(new_sort_state(8, 1, device=cuda))
    box = torch.zeros(2, 4, 5, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fs.fused_sort_chunk(cfg, st, box, torch.ones(2, 4, device=cuda),
                            torch.ones(2, 4, device=cuda), 1)
    with pytest.raises(ValueError):
        fs.fused_sort_chunk(cfg, st, box.float().cpu(),
                            torch.ones(2, 4, device=cuda),
                            torch.ones(2, 4, device=cuda), 1)
    rng = np.random.default_rng(0)
    big = torch.tensor(rng.uniform(size=(1, 2048, 5)), dtype=torch.float32,
                       device=cuda)
    before = profiling.counter("fused_sort.launches")
    with pytest.raises(ValueError, match='engine="step"'):
        fs.fused_sort_chunk(cfg, st, big, torch.ones(1, 2048, device=cuda),
                            torch.ones(1, 2048, device=cuda), 1)
    assert profiling.counter("fused_sort.launches") == before


def test_shape_check_counts_the_library_bytes(cuda):
    """The Python count of the fused kernels' shared bytes equals the
    library's launch plans: VisualSORT's cluster, storage and bytes over a
    grid of (D, T, K), within and past the limit; SORT's storage and bytes
    over (D, T)."""
    from similari_tpu_torch._build import library

    lib = library()
    out = (ctypes.c_int * 4)()
    for d in (1, 8, 100, 128, 1024):
        for t in (1, 200, 512, 1252, 1253, 2573, 2574, 4000, 12816, 12817,
                  51200, 51201):
            for k in (1, 3, 8, 31):
                code = lib.fused_visual_plan(d, t, k, out)
                storage, nbytes = fv.visual_storage(d, t, k)
                assert (out[0], out[1]) == (fv.VISUAL_CLUSTER,
                                            fv.VISUAL_THREADS), (d, t, k)
                assert (code == 0) == (storage >= 0), (d, t, k)
                if storage >= 0:
                    assert (out[2], out[3]) == (storage, nbytes), (d, t, k)
    for d in (1, 100, 128, 1024):
        for t in (1, 200, 512, 2000, 4000, 8000, 24000):
            storage, nbytes = fs.sort_storage(d, t)
            code = lib.fused_sort_plan(d, t, out)
            assert (code == 0) == (storage >= 0), (d, t)
            if storage >= 0:
                assert (out[2], out[3]) == (storage, nbytes), (d, t)


def test_launchers_run_on_the_inputs_device(cuda, monkeypatch):
    """Each of the five launchers enters `torch.cuda.device` with its
    input's device around its launch (the card's current device may be
    another)."""
    entered = []
    real = torch.cuda.device

    class Recording:
        def __init__(self, dev):
            entered.append(dev)
            self.guard = real(dev)

        def __enter__(self):
            return self.guard.__enter__()

        def __exit__(self, *exc):
            return self.guard.__exit__(*exc)

    monkeypatch.setattr(torch.cuda, "device", Recording)
    dev = torch.empty(0, device=cuda).device
    box, valid = sort_stream(0, CHUNK, 8)
    sort_in = [torch.tensor(x, device=cuda)
               for x in _unit_conf(box, valid)]
    vis_in = [torch.tensor(x, device=cuda) for x in visual_stream(0, CHUNK,
                                                                  8, 16)]
    det8 = torch.tensor(random_boxes(np.random.default_rng(0), 40, 50.0),
                        device=cuda)
    state = torch.zeros((2, 6, 16), device=cuda)
    calls = {
        "fused_sort": (lambda: fs.fused_sort_chunk(
            SortConfig(method="iou", oriented=False),
            fs.state_to_tuple(new_sort_state(32, 1, device=cuda)), *sort_in,
            1), 1),
        "fused_visual + gallery_dots": (lambda: fv.fused_visual_chunk(
            VisualConfig(**VISUAL_CONFIGS["euclid_iou"]),
            fv.state_to_tuple(new_visual_state(32, 1, 3, 16, device=cuda)),
            *vis_in, 1), 2),
        "gallery_dots": (lambda: gd.gallery_dots(
            vis_in[3].view(-1, 16), state.view(-1, 16), True, 8), 1),
        "clip_pairs": (lambda: cl.clip_pairs(
            cl.clip_columns(det8), cl.clip_columns(det8), True), 1),
        "lane_merge": (lambda: mi.lane_merge_inplace(
            state, torch.ones((2, 3, 16), device=cuda),
            torch.arange(3, dtype=torch.int32, device=cuda).repeat(2, 1),
            torch.ones((2, 3), dtype=torch.int32, device=cuda)), 1),
        "auction_fb": (lambda: asg.auction_lap_fallback(
            state[..., :5], 0.3), 1),
    }
    for name, (call, guards) in calls.items():
        entered.clear()
        call()
        assert [torch.device(x) for x in entered] == [dev] * guards, name


def _clip_boxes(case):
    """(det boxes [D, 5], trk boxes [T, 5]) as numpy."""
    rng = np.random.default_rng(0)
    if case == "random":
        return random_boxes(rng, 70, 150.0), random_boxes(rng, 45, 150.0)
    if case == "ragged":
        return random_boxes(rng, 1, 20.0), random_boxes(rng, 33, 20.0)
    if case == "touching":  # shared edges and corners: intersection 0
        a = np.array([[0.0, 0.0, 0.0, 1.0, 2.0]] * 3, np.float32)
        b = np.array([[2.0, 0.0, 0.0, 1.0, 2.0], [2.0, 2.0, 0.0, 1.0, 2.0],
                      [0.0, -2.0, 0.0, 1.0, 2.0]], np.float32)
        return a, b
    if case == "degenerate":
        real = np.array([[5.0, 0.0, 0.3, 1.5, 30.0]], np.float32)
        degen = np.array([[0.0, 0.0, 0.0, 0.0, 0.0],
                          [2.0, 1.0, 0.5, 2.0, 0.0],
                          [3.0, 0.0, 0.1, 0.0, 25.0]], np.float32)
        return real, degen
    if case == "far":
        det = random_boxes(rng, 64, 200.0)
        trk = random_boxes(rng, 96, 200.0)
        trk[:, 0] += 1e5
        return det, trk
    raise KeyError(case)


@pytest.mark.parametrize("want_iou", [True, False])
@pytest.mark.parametrize("case", ["random", "ragged", "touching",
                                  "degenerate", "far"])
def test_clip_kernel_matches_plain(cuda, case, want_iou):
    det, trk = (torch.tensor(x, device=cuda) for x in _clip_boxes(case))
    det8, trk8 = cl.clip_columns(det), cl.clip_columns(trk)
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = profiling.counter("clip.launches")
    k = cl.clip_pairs(det8, trk8, want_iou, tiles)
    assert profiling.counter("clip.launches") == before + 1
    p = cl.pair_block_plain(det8, trk8, want_iou)
    torch.cuda.synchronize()
    assert torch.equal(k > 0, p > 0)
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
    assert int(tiles) == int(cl.tiles_to_run(cl.far_pairs(det8, trk8)))
    if case == "touching":
        assert float(k.diagonal().abs().max()) < 1e-5
    if case == "degenerate" and want_iou:
        assert float(k.abs().max()) < 1e-6
    if case == "far":
        assert float(k.abs().max()) == 0.0 and int(tiles) == 0


def test_clip_kernel_identical_boxes_give_exactly_one(cuda):
    cols = torch.tensor(EXACT_BOX_COLUMNS, dtype=torch.float32, device=cuda)
    iou = cl.clip_pairs(cols, cols, True)
    assert torch.equal(iou.diagonal(), torch.ones(len(cols), device=cuda))
    boxes = torch.tensor(random_boxes(np.random.default_rng(1), 100),
                         device=cuda)
    b8 = cl.clip_columns(boxes)
    k = cl.clip_pairs(b8, b8, True).diagonal()
    assert torch.equal(k, cl.pair_block_plain(b8, b8, True).diagonal())
    assert float((k - 1.0).abs().max()) < 1e-6


def test_clip_kernel_rejects_bad_inputs(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        cl.clip_pairs(x, x.cpu(), True)
    with pytest.raises(ValueError, match="tiles"):
        cl.clip_pairs(x, x, True, torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("want_iou", [True, False])
def test_batched_clip_launch_equals_launches_per_scene(cuda, want_iou):
    """One launch over S=5 scenes (D=70, T=535: neither a multiple of 32;
    scene 2 all padding, scene 4 all far apart) is bit-equal, scene by
    scene, to a launch on each scene alone, and runs their tiles."""
    rng = np.random.default_rng(11)
    s, d, t = 5, 70, 535
    det = np.stack([random_boxes(rng, d, 400.0) for _ in range(s)])
    trk = np.stack([random_boxes(rng, t, 400.0) for _ in range(s)])
    det[2], trk[2] = 0.0, 0.0
    trk[4, :, 0] += 1e5
    det8 = cl.clip_columns(torch.tensor(det, device=cuda))
    trk8 = cl.clip_columns(torch.tensor(trk, device=cuda))
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = profiling.counter("clip.launches")
    k = cl.clip_pairs(det8, trk8, want_iou, tiles)
    assert profiling.counter("clip.launches") == before + 1
    assert k.shape == (s, d, t)
    one_tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    for j in range(s):
        assert torch.equal(k[j], cl.clip_pairs(det8[j], trk8[j], want_iou,
                                               one_tiles)), j
    assert int(tiles) == int(one_tiles)
    assert float(k[2].abs().max()) == 0.0 and float(k[4].abs().max()) == 0.0
    assert int(cl.tiles_to_run(cl.far_pairs(det8[4], trk8[4]))) == 0
    assert float(k[0].max()) > 0.0


def test_batched_sorted_sort_step_is_each_scene_alone(cuda):
    """The batched SORT step on CUDA takes the sorted path for oriented
    scenes at its gate: one clip launch a step, no dense oriented IoU, and
    each scene's outputs and state those of the single-scene step."""
    s, n = 3, 4
    streams = [oriented_stream(20 + j, n, 64, spread=2500.0)
               for j in range(s)]
    box, conf, valid = (torch.tensor(np.stack(x, 1), device=cuda)
                        for x in zip(*streams))
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=True)
    step = pmesh.batched_sort_step(cfg)
    st = pmesh.new_batched_state(s, 512, 1, device=cuda)
    one = [new_sort_state(512, 1, device=cuda) for _ in range(s)]
    from similari_tpu_torch.trackers.sort_step import sort_step
    clips = profiling.counter("clip.launches")
    dense = profiling.counter("geometry.oriented_dense")
    for i in range(n):
        ep = torch.full((s,), i + 1, dtype=torch.int32, device=cuda)
        st, out = step(st, box[i], conf[i], valid[i], ep)
        for j in range(s):
            one[j], o = sort_step(cfg, one[j], box[i, j], conf[i, j],
                                  valid[i, j], i + 1)
            for f in ("slot", "track_id", "is_new", "length"):
                assert torch.equal(getattr(o, f), getattr(out, f)[j]), f
    assert profiling.counter("clip.launches") == clips + n * (1 + s)
    assert profiling.counter("geometry.oriented_dense") == dense
    for j in range(s):
        for f in ("active", "track_id", "length", "last_epoch", "next_id"):
            assert torch.equal(getattr(one[j], f), getattr(st, f)[j]), f
        assert torch.equal(one[j].kf.mean_pos, st.kf.mean_pos[j])


def _plain_clip(det8, trk8, want_iou, tiles=None):
    return cl.pair_block_plain(det8, trk8, want_iou)


@pytest.mark.parametrize("block_sort", ["auto", True])
def test_sorted_sort_path_matches_plain_clip(cuda, block_sort, monkeypatch):
    """The general step on CUDA at the sorted path's gate (d=64, t=512)
    launches the clip kernel once per frame and tracks exactly as the same
    run with the plain version in the kernel's place."""
    box, conf, valid = (torch.tensor(x, device=cuda)
                        for x in oriented_stream(3, 6, 64, spread=2500.0))
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=True, oriented_block_sort=block_sort)
    st = new_sort_state(512, 1, device=cuda)
    before = profiling.counter("clip.launches")
    sk, ok = sort_scan(cfg, st, box, conf, valid, 1)
    assert profiling.counter("clip.launches") == before + 6
    monkeypatch.setattr(cl, "clip_pairs", _plain_clip)
    sp, op = sort_scan(cfg, st, box, conf, valid, 1)
    for f in ("slot", "track_id", "is_new", "length", "overflow"):
        assert torch.equal(getattr(ok, f), getattr(op, f)), f
    for f in ("active", "track_id", "length", "last_epoch", "next_id"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    torch.testing.assert_close(sk.pred_box, sp.pred_box, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,block_skip", [(600, None), (200, True)])
def test_block_skip_nms_matches_dense(cuda, n, block_skip):
    rng = np.random.default_rng(5)
    boxes = torch.tensor(random_boxes(rng, n, spread=60.0 * np.sqrt(n)),
                         device=cuda)
    valid = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    before = profiling.counter("clip.launches")
    blk = nms_kernel(boxes, valid, 0.7, block_skip=block_skip)
    assert profiling.counter("clip.launches") == before + 1
    dense = nms_kernel(boxes, valid, 0.7, block_skip=False)
    assert torch.equal(blk, dense)
    assert 0 < int(blk.sum()) < int(valid.sum())


@pytest.mark.parametrize("dtype,f", [
    (torch.bfloat16, 512), (torch.float32, 512), (torch.int32, 512),
    (torch.bfloat16, 3), (torch.float32, 129), (torch.bfloat16, 1)])
def test_merge_kernel_matches_plain(cuda, dtype, f):
    """Bit-equal to the plain version; rows outside [0, R) and rows with
    valid 0 never write; the state is written in place."""
    g = torch.Generator().manual_seed(f)
    s, r, d = 7, 60, 20
    if dtype == torch.int32:
        state = torch.randint(-99, 99, (s, r, f), generator=g,
                              dtype=torch.int32)
        src = torch.randint(-99, 99, (s, d, f), generator=g,
                            dtype=torch.int32)
    else:
        state = torch.randn((s, r, f), generator=g).to(dtype)
        src = torch.randn((s, d, f), generator=g).to(dtype)
    row = torch.stack([torch.randperm(r, generator=g)[:d]
                       for _ in range(s)]).int()
    valid = (torch.rand((s, d), generator=g) < 0.8).int()
    row[:, 0], valid[:, 0] = -3, 0
    row[:, 1], valid[:, 1] = r, 0
    state, src, row, valid = (x.to(cuda) for x in (state, src, row, valid))
    kernel, plain = state.clone(), state.clone()
    before = profiling.counter("merge_inplace.launches")
    out = mi.lane_merge_inplace(kernel, src, row, valid)
    assert profiling.counter("merge_inplace.launches") == before + 1
    assert out.data_ptr() == kernel.data_ptr()
    mi.lane_merge_plain(plain, src, row, valid)
    torch.cuda.synchronize()
    assert torch.equal(kernel.view(torch.int8 if dtype == torch.bfloat16
                                   else dtype),
                       plain.view(torch.int8 if dtype == torch.bfloat16
                                  else dtype))
    assert not torch.equal(kernel, state)


def test_merge_kernel_rejects_bad_inputs(cuda):
    state = torch.zeros(2, 8, 4, device=cuda)
    src = torch.zeros(2, 3, 4, device=cuda)
    row = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mi.lane_merge_inplace(state[:, ::2], src, row, row)
    with pytest.raises(ValueError, match="one device"):
        mi.lane_merge_inplace(state, src.cpu(), row, row)
    with pytest.raises(TypeError):
        mi.lane_merge_inplace(state, src.bfloat16(), row, row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_batched_step_matches_plain_step(cuda, dtype):
    """The in-place batched step launches the merge kernel twice per frame
    and tracks exactly as the plain batched step, from copies of one
    start state."""
    cfg = VisualConfig(**dict(VISUAL_CONFIGS["euclid_iou"],
                              recycle_idle=True))
    s, n, d, t, f = 3, 8, 8, 32, 16
    arrs = [np.stack([x[i] for x in (visual_stream(k, n, d, f)
                                     for k in range(s))], axis=1)
            for i in range(7)]
    ref = pmesh.new_batched_visual_state(s, t, 2, 3, f, dtype, device=cuda)
    alt = map_tensors(torch.clone, ref)
    vstep = pmesh.batched_visual_step(cfg)
    istep = pmesh.batched_visual_step_inplace(cfg)
    before = profiling.counter("merge_inplace.launches")
    for i in range(n):
        args = [torch.tensor(a[i], device=cuda) for a in arrs]
        ep = torch.full((s,), i + 1, device=cuda)
        ref, out_r = vstep(ref, *args, ep)
        alt, out_i = istep(alt, *args, ep)
        for name in ("track_id", "voting_type", "is_new", "overflow"):
            assert torch.equal(getattr(out_r, name), getattr(out_i, name))
    assert profiling.counter("merge_inplace.launches") == before + 2 * n
    for fld in dataclasses.fields(ref):
        if fld.name != "kf":
            assert torch.equal(getattr(ref, fld.name),
                               getattr(alt, fld.name)), fld.name
    assert (out_i.voting_type == VT_VISUAL).any()


# the votes and BestFit kernel ----------------------------------------------

# (S, D, T, K): the cells' scenes alone and many (one block a scene at
# S=1024, clusters of 2 at S=256 and of 8 below), rows and tracks off the
# kernel's 8 x 32 items, many gallery lanes, and each storage plan of
# `visual_votes_plan`: column keys in device memory (T >= ~29,000), no pass
# mask (D x T past shared memory)
VOTE_SHAPES = [(1, 128, 200, 3), (64, 128, 200, 3), (1, 256, 512, 3),
               (16, 256, 512, 3), (1024, 16, 24, 3), (256, 37, 45, 2),
               (3, 9, 33, 1), (2, 3, 70, 4), (1, 1, 1, 1), (1, 4, 30000, 1),
               (2, 40, 29000, 2), (1, 16, 40, 120), (1, 4096, 8192, 1)]


@pytest.mark.parametrize("case", VOTE_CASES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
@pytest.mark.parametrize("shape", VOTE_SHAPES)
def test_votes_kernel_matches_plain(cuda, shape, kind, precision, case):
    """t1, has_any, wins and claimed bit-equal to the plain version on the
    same product and norms, one launch a call."""
    args = votes_args(votes_inputs(sum(shape), *shape, 16, kind, case), kind,
                      precision, cuda)
    plan = (ctypes.c_int * 3)()
    assert _build.library().visual_votes_plan(*shape[:3], 1, plan) == 0
    assert plan[1] == {30000: 2, 29000: 2, 8192: 1}.get(shape[2], 3)
    before = profiling.counter("visual_votes.launches")
    got = vv.visual_best_fit(*args, 1)
    assert profiling.counter("visual_votes.launches") == before + 1
    want = vv.visual_best_fit_plain(*args, 1)
    torch.cuda.synchronize()
    for name, a, b in zip(("t1", "has_any", "wins", "claimed"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if case == "no_pass":
        assert not got[1].any()
    elif case in ("base", "broadcast") and shape[1] >= 9:
        assert got[2].any()


@pytest.mark.parametrize("min_votes", [0, 2, 3])
def test_votes_kernel_matches_plain_at_min_votes(cuda, min_votes):
    args = votes_args(votes_inputs(7, 8, 40, 90, 3, 16, "euclidean"),
                      "euclidean", "f32", cuda)
    got = vv.visual_best_fit(*args, min_votes)
    want = vv.visual_best_fit_plain(*args, min_votes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,dtype", [("euclid_iou", torch.float32),
                                        ("cosine_gates", torch.bfloat16)])
def test_inplace_batched_step_with_the_votes_kernel_matches_plain_votes(
        cuda, monkeypatch, name, dtype):
    """Over a crowded stream with exact duplicate rows, the in-place
    batched step gives the same outputs every frame and the same final
    state, bit for bit, with the kernel (one launch a step) as with the
    plain votes and BestFit patched in."""
    precision = "bf16" if dtype == torch.bfloat16 else "f32"
    cfg = VisualConfig(**dict(VISUAL_CONFIGS[name], recycle_idle=True,
                              feature_precision=precision))
    s, n, d, t, f = 6, 10, 24, 64, 16
    arrs = [np.stack([x[i] for x in (crowded_stream(k, n, d, 14, f, 120.0,
                                                    noise=0.8)
                                     for k in range(s))], axis=1)
            for i in range(7)]
    frames = [[torch.tensor(a[i], device=cuda) for a in arrs]
              for i in range(n)]
    start = pmesh.new_batched_visual_state(s, t, 2, 3, f, dtype, device=cuda)
    istep = pmesh.batched_visual_step_inplace(cfg)

    def run():
        st, outs = map_tensors(torch.clone, start), []
        for i, fr in enumerate(frames):
            st, out = istep(st, *fr, torch.full((s,), i + 1, device=cuda))
            outs.append(out)
        return st, outs

    before = profiling.counter("visual_votes.launches")
    k_state, k_outs = run()
    assert profiling.counter("visual_votes.launches") == before + n
    monkeypatch.setattr(vv, "visual_best_fit", vv.visual_best_fit_plain)
    p_state, p_outs = run()
    for ko, po in zip(k_outs, p_outs):
        for fld in dataclasses.fields(ko):
            assert torch.equal(getattr(ko, fld.name),
                               getattr(po, fld.name)), fld.name
    for fld in dataclasses.fields(k_state):
        a, b = getattr(k_state, fld.name), getattr(p_state, fld.name)
        if fld.name == "kf":
            for sub in dataclasses.fields(a):
                assert torch.equal(getattr(a, sub.name),
                                   getattr(b, sub.name)), sub.name
        else:
            assert torch.equal(a, b), fld.name
    assert any((o.voting_type == VT_VISUAL).any() for o in k_outs)
    assert any(((o.voting_type != VT_VISUAL) & ~o.is_new).any()
               for o in k_outs)


# the fallback auction kernel ------------------------------------------------

# (S, D, T): the stream cells' shapes (1, 2, 4, 5) and one scene
AUCTION_SHAPES = [(1024, 128, 200), (4096, 128, 200), (256, 256, 512),
                  (256, 640, 1024), (1, 128, 200)]


def _auction_both(w, theta, max_iters=asg.MAX_AUCTION_ROUNDS, rv=None,
                  cv=None):
    """(kernel columns, its `auction.rounds`, plain columns, theirs): the
    masked form through `solve_voting` where masks are given (through the
    kernel's wrapper below the default cap, which `solve_voting` keeps)."""
    r0 = profiling.counter("auction.rounds")
    n0 = profiling.counter("auction.launches")
    if rv is None:
        got = asg.auction_lap_fallback(w, theta, max_iters)
        want_w = w
    else:
        got = (asg.solve_voting(w, theta, rv, cv, "auction")
               if max_iters == asg.MAX_AUCTION_ROUNDS
               else asg.auction_fb_cuda(w, theta, max_iters, rv, cv))
        want_w = asg.edges(w, rv, cv)
    assert profiling.counter("auction.launches") == n0 + 1
    r1 = profiling.counter("auction.rounds")
    want = asg.auction_lap_fallback_plain(want_w, theta, max_iters)
    r2 = profiling.counter("auction.rounds")
    return got, r1 - r0, want, r2 - r1


@pytest.mark.parametrize("shape", AUCTION_SHAPES)
def test_auction_kernel_matches_plain_rounds(cuda, shape):
    """Tracking-shaped weights at the cells' shapes, masked as the steps
    give them and raw: columns bit-equal and the same rounds a call."""
    w, rv, cv = (torch.tensor(x, device=cuda)
                 for x in tracking_weights(sum(shape), *shape))
    for masks in ((rv, cv), (None, None)):
        got, rounds, want, p_rounds = _auction_both(w, 0.3, rv=masks[0],
                                                    cv=masks[1])
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert rounds == p_rounds >= asg.UNROLLED_ROUNDS
    assert bool((got >= shape[1]).any())


@pytest.mark.parametrize("max_iters", [1, 2, 3, asg.MAX_AUCTION_ROUNDS])
@pytest.mark.parametrize("case", sorted(AUCTION_CASES))
def test_auction_kernel_matches_plain_on_hard_cases(cuda, case, max_iters):
    """Ties within and across rows, an all-zero scene, every row below
    theta, D > T, T = 1, a contested scene among easy ones, a negative
    theta, NaN and infinite weights; every cap."""
    w, rv, cv, theta = auction_inputs(11, case)
    if case in RAW_CASES:
        max_iters = min(max_iters, RAW_ROUNDS)
    w = torch.tensor(w, device=cuda)
    masks = ((None, None) if rv is None else
             (torch.tensor(rv, device=cuda), torch.tensor(cv, device=cuda)))
    got, rounds, want, p_rounds = _auction_both(w, theta, max_iters, *masks)
    assert torch.equal(got, want)
    assert rounds == p_rounds


def test_auction_kernel_scene_rounds_are_each_scene_alone(cuda):
    """Each scene's rounds, as the kernel writes them, are the plain
    rounds' count for that scene alone, up to the unrolled floor."""
    w, rv, cv, theta = auction_inputs(13, "contested")
    w = asg.edges(*(torch.tensor(x, device=cuda) for x in (w, rv, cv)))
    rounds = torch.zeros(w.shape[0], dtype=torch.int32, device=cuda)
    asg.auction_fb_cuda(w, theta, scene_rounds=rounds)
    assert int(rounds[0]) > asg.UNROLLED_ROUNDS
    for i in range(w.shape[0]):
        before = profiling.counter("auction.rounds")
        asg.auction_lap_fallback_plain(w[i], theta)
        alone = profiling.counter("auction.rounds") - before
        assert max(int(rounds[i]), asg.UNROLLED_ROUNDS) == alone, i


def test_auction_kernel_one_launch_a_call(cuda):
    """A call is one device kernel, `auction_fb_kernel`, and one count of
    `auction.launches`; it never waits for the device."""
    w, rv, cv = (torch.tensor(x, device=cuda)
                 for x in tracking_weights(3, 64, 128, 200))
    call = lambda: asg.solve_voting(w, 0.3, rv, cv, "auction")  # noqa: E731
    call()
    torch.cuda.synchronize()
    before = profiling.counter("auction.launches")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in profiling.device_events(prof)]
    assert len(names) == 3 and all("auction_fb_kernel" in n for n in names)
    assert profiling.counter("auction.launches") == before + 3


def test_auction_kernel_with_column_scratch(cuda):
    """Columns past shared memory (T = 20,000) live in device scratch."""
    plan = (ctypes.c_int * 4)()
    assert _build.library().auction_fb_plan(2, 100, 20000, plan) == 0
    assert plan[2] == 0
    w, rv, cv = (torch.tensor(x, device=cuda)
                 for x in tracking_weights(5, 2, 100, 20000))
    got, rounds, want, p_rounds = _auction_both(w, 0.3, rv=rv, cv=cv)
    assert torch.equal(got, want) and rounds == p_rounds


@pytest.mark.parametrize("kw,err", [
    (dict(weights=(1, 20000, 4)), ValueError),  # rows past shared memory
    (dict(dtype=torch.float64), TypeError),
    (dict(row_valid=(2, 3)), ValueError),  # one mask only
    (dict(row_valid=(2, 3), col_valid=(2, 4), mask_dtype=torch.int32),
     TypeError),
    (dict(weights=(2, 2, 3, 4)), ValueError),
    (dict(weights=(2, 0, 4)), ValueError),
    (dict(weights=(2, 3, 0)), ValueError),
    (dict(scene_rounds=torch.int64), ValueError),
])
def test_auction_kernel_refuses_bad_inputs(cuda, kw, err):
    """Shapes, dtypes and masks are checked before any launch."""
    kw = dict(kw)
    mask = kw.pop("mask_dtype", torch.bool)
    args = dict(weights=torch.zeros(kw.pop("weights", (2, 3, 4)),
                                    dtype=kw.pop("dtype", torch.float32),
                                    device=cuda), theta=0.3)
    for name in ("row_valid", "col_valid"):
        if name in kw:
            args[name] = torch.ones(kw.pop(name), dtype=mask, device=cuda)
    if "scene_rounds" in kw:
        args["scene_rounds"] = torch.zeros(2, dtype=kw.pop("scene_rounds"),
                                           device=cuda)
    before = profiling.counter("auction.launches")
    with pytest.raises(err):
        asg.auction_fb_cuda(**args)
    assert profiling.counter("auction.launches") == before


def test_batched_steps_sync_only_at_counted_waits(cuda, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("error"), relaxed only inside
    `utils/profiling.py::wait` spans, the batched VisualSORT (in place)
    and SORT steps run crowded frames, whose auctions take extra rounds:
    every sync of a step is a counted wait site, and the only one is
    `merge.written`: the auction kernel bids to convergence on the card,
    with no `auction.converged` wait."""
    enter, leave = profiling.wait.__enter__, profiling.wait.__exit__

    def relaxed(self):
        torch.cuda.set_sync_debug_mode(0)
        return enter(self)

    def strict(self, *exc):
        out = leave(self, *exc)
        torch.cuda.set_sync_debug_mode("error")
        return out

    s, n, d, t, f = 4, 6, 24, 64, 16
    arrs = [np.stack([x[i] for x in (crowded_stream(k, n, d, 14, f, 120.0)
                                     for k in range(s))], axis=1)
            for i in range(7)]
    frames = [[torch.tensor(a[i], device=cuda) for a in arrs]
              for i in range(n)]
    eps = [torch.full((s,), i + 1, dtype=torch.int32, device=cuda)
           for i in range(n)]
    vcfg = VisualConfig(**dict(VISUAL_CONFIGS["euclid_iou"],
                               assignment="auction", recycle_idle=True))
    scfg = SortConfig(method="iou", assignment="auction", oriented=False,
                      recycle_idle=True)
    vstep = pmesh.batched_visual_step_inplace(vcfg)
    sstep = pmesh.batched_sort_step(scfg)

    def states():
        return (pmesh.new_batched_visual_state(s, t, 1, 3, f, device=cuda),
                pmesh.new_batched_state(s, t, 1, device=cuda))

    def run(vst, sst):
        for fr, ep in zip(frames, eps):
            vst, _ = vstep(vst, *fr, ep)
            sst, _ = sstep(sst, fr[0], fr[1], fr[2], ep)

    run(*states())  # the kernel library and the libraries' first calls
    start = states()
    torch.cuda.synchronize()
    monkeypatch.setattr(profiling.wait, "__enter__", relaxed)
    monkeypatch.setattr(profiling.wait, "__exit__", strict)
    profiling.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(*start)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    summ = profiling.summary()  # reads the device's rounds: a sync
    rounds = summ["counts"]["auction.rounds"]
    assert rounds > 2 * n * 3  # some auction ran past its unrolled rounds
    assert summ["counts"]["auction.launches"] == 2 * n
    # the scalar writes of `merge.written`: one in each step's state write;
    # the votes and BestFit and the auction are one kernel launch each,
    # with no wait
    assert summ["waits"]["merge.written"]["syncs"] == 2 * n
    assert set(summ["waits"]) == {"merge.written"}
    spans = summ["spans"]
    assert spans["visual_step.best_fit"]["syncs"] == 0
    assert spans["visual_step.auction"]["syncs"] == 0
    assert spans["sort_step.auction"]["syncs"] == 0
    assert summ["counts"]["visual_votes.launches"] == n
    assert spans["batched_visual_step"]["calls"] == n
    assert spans["batched_sort_step"]["calls"] == n
    assert spans["batched_visual_step"]["syncs"] == n
    assert spans["batched_sort_step"]["syncs"] == n


def test_f32_products_are_not_tf32(cuda):
    """The gallery distances take their f32 products in full f32."""
    assert torch.backends.cuda.matmul.allow_tf32 is False


# the public trackers on the card ------------------------------------------

def _api_frames(seed, steps, d):
    """oriented_stream's frames, valid rows only, as (boxes, conf)."""
    box, conf, valid = oriented_stream(seed, steps, d, spread=2500.0)
    return [(box[s][valid[s]], conf[s][valid[s]]) for s in range(steps)]


def _run_sort_api(dev, frames):
    from similari_tpu_torch import PositionalMetricType, Sort

    tr = Sort(method=PositionalMetricType.iou(0.3), initial_capacity=512,
              device=dev)
    return [tr.predict_arrays(0, b, c) for b, c in frames]


def test_sort_api_oriented_matches_plain_clip(cuda, monkeypatch):
    """`Sort` on rotated boxes at the sorted path's gate launches the clip
    kernel once per predict and tracks exactly as the same tracker with
    the plain version in the kernel's place."""
    frames = _api_frames(5, 6, 100)
    before = profiling.counter("clip.launches")
    kernel = _run_sort_api(cuda, frames)
    assert profiling.counter("clip.launches") == before + len(frames)
    monkeypatch.setattr(cl, "clip_pairs", _plain_clip)
    plain = _run_sort_api(cuda, frames)
    for (_, ik, pk, lk, sk), (_, ip, pp, lp, sp) in zip(kernel, plain):
        for a, b in ((ik, ip), (lk, lp), (sk, sp)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(pk, pp, rtol=RTOL, atol=ATOL)


def _run_batch_visual_api(dev, n_frames):
    from similari_tpu_torch import (BatchVisualSort, Universal2DBox,
                                    VisualSortMetricType,
                                    VisualSortObservation, VisualSortOptions,
                                    VisualSortPredictionBatchRequest)

    opts = (VisualSortOptions()
            .visual_metric(VisualSortMetricType.euclidean(3.0))
            .visual_minimal_track_length(2)
            .visual_max_observations(3).kept_history_length(2)
            .feature_precision("bf16"))
    tr = BatchVisualSort(opts=opts, initial_capacity=16, device=dev)
    streams = [visual_stream(k, n_frames, 12, 16) for k in range(3)]
    out = []
    for i in range(n_frames):
        req = VisualSortPredictionBatchRequest()
        for sid, (box, conf, valid, feat, fvalid, qual, _) in enumerate(
                streams):
            for r in np.nonzero(valid[i])[0]:
                req.add(sid, VisualSortObservation(
                    feat[i, r] if fvalid[i, r] else None, float(qual[i, r]),
                    Universal2DBox.from_vec5(box[i, r], float(conf[i, r])),
                    int(r)))
        res = tr.predict(req)
        while res.ready():
            sid, tracks = res.get()
            out.append((sid, [(t.id, t.length, t.voting_type.name,
                               t.custom_object_id) for t in tracks]))
    return out, tr


def test_batch_visual_api_matches_plain_merge(cuda, monkeypatch):
    """`BatchVisualSort` launches the merge kernel twice per predict and
    tracks exactly as itself with the merge's plain version."""
    before = profiling.counter("merge_inplace.launches")
    kernel, tr = _run_batch_visual_api(cuda, 8)
    assert profiling.counter("merge_inplace.launches") == before + 2 * 8
    assert tr._engine.state.feats.dtype == torch.bfloat16
    monkeypatch.setattr(pmesh, "lane_merge_inplace", mi.lane_merge_plain)
    plain, _ = _run_batch_visual_api(cuda, 8)
    assert kernel == plain
    assert any(v == "Visual" for _, ts in kernel for _, _, v, _ in ts)


def test_grow_visual_state_keeps_bf16_on_card(cuda):
    from similari_tpu_torch.trackers.visual_state import grow_visual_state

    st = new_visual_state(8, 2, 3, 16, torch.bfloat16, device=cuda)
    st.voting_type[:] = 1
    big = grow_visual_state(st, 32)
    assert big.feats.dtype == big.hist_feat.dtype == torch.bfloat16
    assert big.feats.device == big.voting_type.device == st.feats.device
    assert big.capacity == 32 and big.feats.shape == (32, 3, 16)
    assert (big.voting_type[8:] == -1).all() and (big.voting_type[:8] == 1).all()
    assert not big.active.any()


def test_native_assignment_returns_to_the_card(cuda):
    """assignment="native": the weights go to the host C++ solver and the
    columns come back to the card, equal to the solver on the host copy."""
    from similari_tpu_torch.ops import assignment as asg
    from similari_tpu_torch.ops.lap import lap_max_batch

    rng = np.random.default_rng(8)
    w = rng.integers(0, 5, (3, 9, 20)).astype(np.float32)
    cols = asg.solve_lap(torch.tensor(w, device=cuda), "native")
    assert cols.device.type == "cuda"
    np.testing.assert_array_equal(cols.cpu().numpy(), lap_max_batch(w))


def test_host_engines_with_the_default_device(cuda):
    """device=None means the card: engine="host" keeps a numpy state and
    gives the device engine's ids; a bf16 VisualSort under "host" keeps
    its bf16 state on the card."""
    import similari_tpu_torch as pt

    box = np.array([[10.0, 10.0, 0.0, 0.5, 20.0],
                    [90.0, 10.0, 0.3, 0.5, 20.0]], np.float32)
    conf = np.ones(2, np.float32)
    ids = []
    for engine in ("host", "device"):
        tr = pt.Sort(method=pt.PositionalMetricType.iou(0.3), engine=engine)
        for _ in range(3):
            ids.append(tr.predict_arrays(0, box, conf)[1].tolist())
        leaf = tr._scenes[0].state.active
        assert isinstance(leaf, np.ndarray) == (engine == "host")
    assert ids[:3] == ids[3:] == [[1, 2]] * 3
    vs = pt.VisualSort(opts=pt.VisualSortOptions().feature_precision("bf16"),
                       engine="host")
    vs.predict_arrays(0, box, conf, np.ones((2, 4), np.float32))
    st = vs._scenes[0].state
    assert st.feats.device.type == "cuda" and st.feats.dtype == torch.bfloat16


@pytest.fixture
def world():
    """The process groups a test's meshes build, destroyed after it."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_sharded_visual_step_on_nccl_matches_inplace_step(cuda, world):
    """The sharded visual step on an NCCL mesh of one rank: the unsharded
    in-place step's outputs and state, the new-track count reduced, two
    merge launches per frame."""
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    mesh = pmesh.scene_mesh(1)
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    s, n, d, t, f = 3, 6, 8, 32, 16
    arrs = [np.stack([x[i] for x in (visual_stream(k, n, d, f)
                                     for k in range(s))], axis=1)
            for i in range(7)]
    ref = pmesh.new_batched_visual_state(s, t, 2, 3, f, torch.bfloat16,
                                         device=cuda)
    alt = map_tensors(torch.clone, ref)
    sstep = pmesh.sharded_visual_step(cfg, mesh)
    istep = pmesh.batched_visual_step_inplace(cfg)
    before = profiling.counter("merge_inplace.launches")
    for i in range(n):
        args = [torch.tensor(a[i], device=cuda) for a in arrs]
        ep = torch.full((s,), i + 1, device=cuda)
        ref, out_r = istep(ref, *args, ep)
        alt, out_s, new = sstep(alt, *args, ep)
        for name in ("track_id", "voting_type", "is_new", "overflow"):
            assert torch.equal(getattr(out_r, name), getattr(out_s, name))
        assert int(new) == int(out_r.is_new.sum())
    assert profiling.counter("merge_inplace.launches") == before + 4 * n
    for fld in dataclasses.fields(ref):
        if fld.name != "kf":
            assert torch.equal(getattr(ref, fld.name),
                               getattr(alt, fld.name)), fld.name


def test_gloo_mesh_refuses_card_tensors(cuda, world):
    """A mesh on the CPU's backend (gloo) given tensors on the card raises
    rather than copying them."""
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    mesh = pmesh.scene_mesh(1, device="cpu")
    assert mesh.backend == "gloo"
    st = pmesh.new_batched_visual_state(2, 8, 1, 3, 4, device=cuda)
    box = torch.zeros((2, 4, 5), device=cuda)
    ones = torch.ones((2, 4), device=cuda)
    with pytest.raises(ValueError, match="gloo"):
        pmesh.sharded_visual_step(cfg, mesh)(
            st, box, ones, ones > 0, torch.zeros((2, 4, 4), device=cuda),
            ones > 0, ones, ones, torch.ones(2, dtype=torch.int32,
                                             device=cuda))


def test_mot_file_route_on_the_card(cuda, tmp_path):
    """run_sequence_device(path) reads a 6-column file with a header line
    through the C++ loader and runs the fused kernel on the card: the
    in-memory run's outputs, one launch per 16-frame chunk."""
    from similari_tpu_torch.eval import mot as pmot
    from torch_parity import churn_stream, write_mot_det

    dets = {}
    for f, (box, conf) in enumerate(churn_stream(4, 20, 12, spread=300.0),
                                    start=1):
        w = box[:, 3] * box[:, 4]
        dets[f] = [(float(x - ww / 2), float(y - h / 2), float(ww), float(h),
                    float(c)) for (x, y, _, _, h), ww, c in zip(box, w, conf)]
    path = tmp_path / "det.txt"
    held = write_mot_det(path, dets, columns=6, header=True)
    before = profiling.counter("fused_sort.launches")
    got, _ = pmot.run_sequence_device(path, capacity=64)
    assert profiling.counter("fused_sort.launches") == before + 2
    want, _ = pmot.run_sequence_device(held, capacity=64)
    assert got == want and len(got) == 20


def _zero_height_frames(seed, steps=16, n=24):
    from torch_parity import churn_stream

    rng = np.random.default_rng(seed)
    out = []
    for box, conf in churn_stream(seed, steps, n, spread=400.0, churn=4):
        box = box.copy()
        box[rng.random(n) < 0.1, 4] = 0.0
        out.append((box, conf))
    return out


def test_zero_height_auction_on_the_card(cuda):
    """Valid zero-height detections turn a Mahalanobis weight NaN; the
    card's auction takes it as no edge (no device-side assert) and gives
    the ids of the CPU's exact "native" solver, then the card keeps
    working."""
    from similari_tpu_torch import PositionalMetricType, Sort

    frames = _zero_height_frames(6)

    def run(device, backend):
        tr = Sort(shards=1, bbox_history=2, max_idle_epochs=3,
                  method=PositionalMetricType.maha(), initial_capacity=32,
                  assignment_backend=backend, device=device)
        return [tr.predict_arrays(0, b, c)[1].tolist() for b, c in frames]

    assert run(cuda, "auction") == run("cpu", "native")
    torch.cuda.synchronize()
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


def test_zero_height_fused_runners_match_plain(cuda, monkeypatch):
    """The fused runners on a zero-height stream: kernel outputs equal to
    the plain chunks on the card."""
    from similari_tpu_torch.eval import generate_sequence
    from similari_tpu_torch.eval import mot as pmot

    _, dets, feats = generate_sequence(n_objects=12, n_frames=32, seed=3,
                                       feature_dim=16)
    rng = np.random.default_rng(3)
    dets = {f: [r[:3] + (0.0,) + r[4:] if rng.random() < 0.1 else r
                for r in rows] for f, rows in dets.items()}
    runs = (lambda: pmot.run_sequence_device(dets, capacity=64),
            lambda: pmot.run_sequence_device_visual(
                dets, feats, capacity=64, positional_kind="maha"))
    kern = [run() for run in runs]
    monkeypatch.setattr(fs, "fused_sort_chunk", fs.fused_sort_chunk_plain)
    monkeypatch.setattr(fv, "fused_visual_chunk", fv.fused_visual_chunk_plain)
    for (k, _), run in zip(kern, runs):
        p, _ = run()
        assert sorted(k) == sorted(p)
        for f in k:
            assert [r[0] for r in k[f]] == [r[0] for r in p[f]]
            np.testing.assert_allclose(np.array([r[1:] for r in k[f]]),
                                       np.array([r[1:] for r in p[f]]),
                                       rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
def test_track_store_on_the_card_matches_cpu(cuda, kind):
    """TrackStore(device="cuda") keeps its feature index on the card; the
    arrays query and the record stream agree with a device="cpu" store."""
    from similari_tpu_torch.core import ObservationBuilder, TrackStoreBuilder
    from similari_tpu_torch.core.examples import (BatchedSimpleMetric,
                                                  SimpleAttributeUpdate,
                                                  SimpleAttrs)

    rng = np.random.default_rng(9)
    feats = rng.normal(size=(200, 3, 64)).astype(np.float32)
    cand_feats = rng.normal(size=(3, 64)).astype(np.float32)

    def run(device):
        metric = BatchedSimpleMetric()
        metric.supports_batch_features = kind
        store = (TrackStoreBuilder(2, device=device)
                 .default_attributes(SimpleAttrs()).metric(metric).build())
        for tid in range(200):
            for k in range(3):
                store.add(tid, 0, 0.1 * (tid % 4), feats[tid, k],
                          SimpleAttributeUpdate() if k == 0 else None)
        b = store.new_track(999)
        for i, f in enumerate(cand_feats):
            b = b.observation(ObservationBuilder(0).observation_attributes(0.2)
                              .observation(f).track_attributes_update(
                                  SimpleAttributeUpdate() if i == 0 else None)
                              .build())
        cand = b.build()
        arrays = store.foreign_track_distances_arrays(cand, 0)
        recs, errs = store.foreign_track_distances([cand], 0, False)
        assert not errs and store.bulk_fallbacks == 0
        assert store._feature_index(0).rows.device.type == \
            torch.device(device).type
        return arrays, recs

    (ta, oa, da), ra = run(cuda)
    (tb, ob, db), rb = run("cpu")
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-4)
    assert [(r.from_id, r.to_id, r.attribute_metric) for r in ra] == \
        [(r.from_id, r.to_id, r.attribute_metric) for r in rb]
    np.testing.assert_allclose([r.feature_distance for r in ra],
                               [r.feature_distance for r in rb],
                               rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------
# the last tools (similari_tpu_torch/tools/)
# --------------------------------------------------------------------------

def test_batch_merge_forms_are_bit_equal_on_card(cuda):
    from similari_tpu_torch.tools import experiment_batch_merge as ebm

    arrays = ebm.make_inputs(8, 50, 3, 64, 24, 4, seed=2)
    results, finals, launches = ebm.experiment(
        cuda, ebm.to_device(arrays, cuda), reps=1)
    _, cpu_finals, _ = ebm.experiment(
        torch.device("cpu"), ebm.to_device(arrays, torch.device("cpu")),
        reps=1)
    assert launches == 2 * 4  # the warm-up chain and one timed chain
    for form, state in finals.items():
        assert torch.equal(state, finals["kernel"]), form
        assert torch.equal(state.cpu(), cpu_finals[form]), form


def test_fused_batch_scenes_equal_their_lone_runs_on_card(cuda):
    from similari_tpu_torch.tools import experiment_pallas_batch as epb

    shape = (8, 16, 64, 3, 32)
    _, first, launches, all_args = epb.measure(cuda, 2, iters=2, reps=1,
                                               shape=shape)
    assert launches == {"fused_visual": 4, "gallery_dots": 4}
    for got, want in zip(first, epb.lone_ids(cuda, all_args, t=64, k=3,
                                             f=32)):
        assert torch.equal(got, want)


def test_ablation_merge_stage_matches_cpu_on_card(cuda):
    from similari_tpu_torch.tools import ablate_visual as abl

    cpu = torch.device("cpu")
    states = []
    for dev in (cuda, cpu):
        inp = abl.make_inputs(3, dev, n_objects=20, feat_dim=64, base_len=4)
        st = abl.fresh_state(inp)
        src = inp.feat[0].to(torch.bfloat16).expand(inp.feat.shape)
        for i in range(3):
            st = abl.merge_stage(st, inp.boxes[i], inp.ones,
                                 src.contiguous(), abl.merge_slots(inp, i))
        states.append(st)
    from similari_tpu_torch.convert import visual_state_to_numpy

    card, host = (visual_state_to_numpy(st) for st in states)
    for key, want in host.items():
        if key == "kf":
            continue  # the merge stage leaves the Kalman state alone
        np.testing.assert_array_equal(card[key], want, err_msg=key)


def test_margins_own_area_probe_on_card(cuda):
    from similari_tpu_torch.eval.mot import ltwh_to_vec5
    from similari_tpu_torch.eval.synthetic import (
        generate_reid_adversarial_sequence)
    from similari_tpu_torch.tools import decision_margins as pdm

    _, dets, _, _ = generate_reid_adversarial_sequence("reid_crossing", 0,
                                                       n_frames=40)
    probe = pdm.MarginProbe(None, pdm.OWN_AREA_GATES, cuda)
    for f in sorted(dets)[::10]:
        rows = np.asarray(dets[f], np.float32)
        probe.probe_own_area(ltwh_to_vec5(rows), np.clip(rows[:, 4], 0, 1))
    assert probe.ownarea_deltas and max(probe.ownarea_deltas) <= 1e-6
