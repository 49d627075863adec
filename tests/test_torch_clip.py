"""The clip kernel's plain version (ops/clip.py) and the port's NMS
(ops/nms.py) against the JAX package, on the CPU.

The JAX block-skip functions run their Pallas kernel in interpret mode.
IoU and areas are held at rtol/atol 2e-4, the tolerance of
tests/test_pallas_clip.py, and validity masks must agree except where the
IoU itself is below 1e-4; NMS keep masks must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import pallas_clip as jclip
from similari_tpu.ops.nms import nms_kernel as jax_nms
from similari_tpu_torch.ops import clip as cl
from similari_tpu_torch.ops.nms import nms_kernel, use_block_skip
from similari_tpu_torch.utils import profiling

from kernel_replay import clip_lanes_replay
from torch_parity import EXACT_BOX_COLUMNS, one_cpu_thread, random_boxes

one_cpu_thread()

TOL = 2e-4


def test_clip_columns_match_jax():
    b = random_boxes(np.random.default_rng(0), 64)
    j = np.asarray(jclip.clip_columns(jnp.asarray(b)))
    p = cl.clip_columns(torch.tensor(b)).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("d,t", [(130, 300), (64, 128)])
def test_blockskip_iou_matches_jax(d, t):
    rng = np.random.default_rng(3)
    det, trk = random_boxes(rng, d), random_boxes(rng, t)
    ij, vj = jclip.oriented_iou_blockskip(jnp.asarray(det), jnp.asarray(trk),
                                          interpret=True)
    ip, vp = cl.oriented_iou_blockskip(torch.tensor(det), torch.tensor(trk))
    ij = np.asarray(ij)
    np.testing.assert_allclose(ip.numpy(), ij, rtol=TOL, atol=TOL)
    diff = vp.numpy() != np.asarray(vj)
    assert np.all(ij[diff] < 1e-4)
    assert vp.any()


@pytest.mark.parametrize("d,t", [(130, 300), (64, 128)])
def test_blockskip_inter_matches_jax(d, t):
    rng = np.random.default_rng(8)
    det = random_boxes(rng, d, spread=300.0)
    trk = random_boxes(rng, t, spread=300.0)
    j = np.asarray(jclip.oriented_inter_blockskip(
        jnp.asarray(det), jnp.asarray(trk), interpret=True))
    p = cl.oriented_inter_blockskip(torch.tensor(det), torch.tensor(trk))
    np.testing.assert_allclose(p.numpy(), j, rtol=TOL, atol=TOL * 100)
    assert (p > 0).sum() > d


def test_far_clusters_are_exactly_zero_and_skip():
    rng = np.random.default_rng(4)
    det = random_boxes(rng, 64, spread=200.0)
    trk = random_boxes(rng, 128, spread=200.0)
    trk[:, 0] += 100000.0
    tiles = torch.zeros(1, dtype=torch.int32)
    iou, valid = cl.oriented_iou_blockskip(torch.tensor(det),
                                           torch.tensor(trk), tiles)
    assert not valid.any() and float(iou.abs().max()) == 0.0
    assert int(tiles) == 0


def test_tiles_to_run_counts_tiles_with_a_near_pair():
    """Two clusters, each 40 boxes: only the two diagonal blocks of 32 x 32
    tiles hold near pairs."""
    rng = np.random.default_rng(6)
    a = random_boxes(rng, 40, spread=100.0)
    b = a.copy()
    b[:, 0] += 1e5
    boxes = torch.tensor(np.concatenate([a, b]))
    cols = cl.clip_columns(boxes)
    far = cl.far_pairs(cols, cols)
    # rows/cols 0-39 and 40-79: tiles (0,0), (0,1), (1,0), (1,1) touch the
    # first cluster, (1,1), (1,2), (2,1), (2,2) the second
    assert int(cl.tiles_to_run(far)) == 7
    tiles = torch.zeros(1, dtype=torch.int32)
    cl.clip_pairs(cols, cols, True, tiles)
    assert int(tiles) == 7


def test_degenerate_boxes_are_near_zero():
    real = torch.tensor([[5.0, 0.0, 0.3, 1.5, 30.0]])
    degen = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0],
                          [2.0, 1.0, 0.5, 2.0, 0.0],
                          [3.0, 0.0, 0.1, 0.0, 25.0]])
    iou, _ = cl.oriented_iou_blockskip(real, degen)
    assert float(iou.abs().max()) < 1e-6
    jiou, _ = jclip.oriented_iou_blockskip(jnp.asarray(real.numpy()),
                                           jnp.asarray(degen.numpy()),
                                           interpret=True)
    assert float(np.abs(np.asarray(jiou)).max()) < 1e-6


def test_identical_rotated_boxes_give_exactly_one():
    """Boxes with integer corner offsets clip exactly: IoU 1.0, in the port
    and in the JAX kernel.  Any other box against itself comes within a
    few ulp of 1, never 0 (what a contracted multiply-add gives)."""
    cols = torch.tensor(EXACT_BOX_COLUMNS, dtype=torch.float32)
    assert torch.equal(cl.pair_block_plain(cols, cols, True).diagonal(),
                       torch.ones(len(cols)))
    pad = np.zeros((128, 8), np.float32)
    pad[: len(cols)] = cols.numpy()
    j = np.asarray(jclip._compiled_call(128, 128, True, True)(
        jnp.asarray(pad), jnp.asarray(pad.T)))
    np.testing.assert_array_equal(np.diag(j)[: len(cols)], 1.0)
    boxes = torch.tensor(random_boxes(np.random.default_rng(2), 200))
    iou, _ = cl.oriented_iou_blockskip(boxes, boxes)
    assert float((iou.diagonal() - 1.0).abs().max()) < 1e-6


def _replay_inputs(case):
    """Clip columns (det8, trk8) of this file's streams."""
    if case == "exact":
        cols = torch.tensor(EXACT_BOX_COLUMNS, dtype=torch.float32)
        return cols, cols
    if case == "degenerate":
        det = np.array([[5.0, 0.0, 0.3, 1.5, 30.0]], np.float32)
        trk = np.array([[0.0, 0.0, 0.0, 0.0, 0.0], [2.0, 1.0, 0.5, 2.0, 0.0],
                        [3.0, 0.0, 0.1, 0.0, 25.0]], np.float32)
    elif case == "touching":  # shared edges and corners
        det = np.array([[0.0, 0.0, 0.0, 1.0, 2.0]] * 3, np.float32)
        trk = np.array([[2.0, 0.0, 0.0, 1.0, 2.0], [2.0, 2.0, 0.0, 1.0, 2.0],
                        [0.0, -2.0, 0.0, 1.0, 2.0]], np.float32)
    elif case == "self":
        det = trk = random_boxes(np.random.default_rng(2), 200)
    elif case == "iou":
        rng = np.random.default_rng(3)
        det, trk = random_boxes(rng, 130), random_boxes(rng, 300)
    else:  # "inter": the dense stream
        rng = np.random.default_rng(8)
        det = random_boxes(rng, 130, spread=300.0)
        trk = random_boxes(rng, 300, spread=300.0)
    return (cl.clip_columns(torch.tensor(det)),
            cl.clip_columns(torch.tensor(trk)))


@pytest.mark.parametrize("want_iou", [True, False])
@pytest.mark.parametrize("case", ["iou", "inter", "self", "exact",
                                  "degenerate", "touching"])
def test_lane_replay_matches_plain_bit_for_bit(case, want_iou):
    """The kernel's split (the in-radius pairs listed; each pair's 8 edge
    terms on 8 lanes, added in the fixed order) equals the plain version
    bit for bit."""
    det8, trk8 = _replay_inputs(case)
    replay = clip_lanes_replay(det8, trk8, want_iou)
    plain = cl.pair_block_plain(det8, trk8, want_iou)
    assert torch.equal(replay, plain)
    assert bool((~cl.far_pairs(det8, trk8)).any())  # pairs were listed


def test_clip_pairs_checks_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="det8"):
        cl.clip_pairs(torch.zeros(4, 5), x, True)
    with pytest.raises(TypeError):
        cl.clip_pairs(x.double(), x, True)
    with pytest.raises(ValueError, match="tiles"):
        cl.clip_pairs(x, x, True, torch.zeros(1, dtype=torch.int64))
    before = profiling.counter("clip.launches")
    cl.clip_pairs(x, x, True)  # the CPU runs the plain version
    assert profiling.counter("clip.launches") == before


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------

def _nms_inputs(seed, n, frac):
    rng = np.random.default_rng(seed)
    b = random_boxes(rng, n, spread=60.0 * np.sqrt(n))
    return b, rng.uniform(size=n) < frac


@pytest.mark.parametrize("route", ["dense", "aligned", "block_skip"])
@pytest.mark.parametrize("n,frac", [(64, 1.0), (300, 0.9)])
def test_nms_matches_jax(route, n, frac):
    b, valid = _nms_inputs(n, n, frac)
    oriented = route != "aligned"
    if not oriented:
        b[:, 2] = 0.0
    block = route == "block_skip"
    j = np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(valid),
                           jnp.float32(0.7), oriented, block_skip=block))
    p = nms_kernel(torch.tensor(b), torch.tensor(valid), 0.7, oriented,
                   block_skip=block).numpy()
    np.testing.assert_array_equal(p, j)
    assert 0 < p.sum() < valid.sum()  # some boxes are suppressed


def test_nms_block_skip_matches_dense_on_long_chains():
    """A row of boxes each overlapping the next: the fixpoint needs more
    than its unrolled rounds; sorted and dense routes keep the same."""
    n = 40
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = np.arange(n) * 12.0
    b[:, 2] = 0.2
    b[:, 3] = 1.0
    b[:, 4] = 20.0
    valid = torch.ones(n, dtype=torch.bool)
    dense = nms_kernel(torch.tensor(b), valid, 0.3, block_skip=False)
    blk = nms_kernel(torch.tensor(b), valid, 0.3, block_skip=True)
    assert torch.equal(dense, blk)
    assert torch.equal(dense, torch.arange(n) % 2 == 0)


def test_nms_routes_and_gate():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert use_block_skip(None, True, 0, 512, cuda)
    assert not use_block_skip(None, True, 0, 512, cpu)
    assert not use_block_skip(None, True, 0, 511, cuda)
    assert not use_block_skip(None, False, 0, 1000, cuda)
    assert use_block_skip(True, True, 0, 8, cpu)
    assert not use_block_skip(False, True, 0, 1000, cuda)
    assert not use_block_skip(None, True, 2, 1000, cuda)
    # neighbors > 0 takes the top-k clip: the row of overlapping boxes
    # keeps every other box with each box's 2 nearest partners clipped
    b = np.zeros((8, 5), np.float32)
    b[:, 0] = np.arange(8) * 12.0
    b[:, 2:] = (0.2, 1.0, 20.0)
    valid = torch.ones(8, dtype=torch.bool)
    keep = nms_kernel(torch.tensor(b), valid, 0.3, neighbors=2)
    assert torch.equal(keep, torch.arange(8) % 2 == 0)
    assert torch.equal(keep, nms_kernel(torch.tensor(b), valid, 0.3))
