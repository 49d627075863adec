"""Rotated-box IoU and intersection with `too_far` tile skipping (mirrors
`similari_tpu/ops/pallas_clip.py`).

`clip_pairs` launches the CUDA kernel `clip_pairs_kernel`
(`csrc/clip.cu`) for CUDA tensors and runs its plain PyTorch version,
`pair_block_plain`, for CPU tensors.  Both take per-box clip columns
(`clip_columns`: centre, two corner offsets, radius, area, so the pair
work needs no trig) of detections [S?, D, 8] and tracks [S?, T, 8] and
give the [S?, D, T] rotated IoU, or the raw intersection area, by the
Green's-theorem boundary integral of `ops/geometry.py`, with each pair
recentred around the midpoint of its centres as vertex = offset +- half
the centre delta.  `too_far` pairs are exactly 0.  The kernel skips the
clip for every 32 x 32 tile of pairs with no pair in radius; callers feed
it x-sorted boxes (`trackers/sort_step.py::_match_sorted`, `ops/nms.py`)
so the in-radius pairs gather near the diagonal and most tiles skip.

A leading scene axis is one launch over every scene (grid.z), each scene
with its own tiles; each scene's result is bit-equal to a call on that
scene alone.  On the CPU the plain version runs scene by scene.

The result does not depend on the tile: the plain version computes every
pair densely and zeroes the far ones.

While a profiler records, a call without its own `tiles` counter keeps
the tiles that ran and the tiles of the launch (`utils/profiling.py::
keep`, as `clip.tiles_run` and `clip.tiles`, one row a call), so an
unprofiled call reads nothing back.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, keep, recording

TILE = 32  # the kernel's tile edge: a tile is TILE x TILE (det, trk) pairs
_F32 = torch.float32


def clip_columns(boxes: torch.Tensor) -> torch.Tensor:
    """vec5 [..., 5] -> clip columns [..., 8]:
    (xc, yc, r1x, r1y, r2x, r2y, radius, area); the corners are +r1, +r2,
    -r1, -r2 around the centre, as `geometry.box_vertices`."""
    angle = boxes[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    hw = boxes[..., 3] * boxes[..., 4] * 0.5
    hh = boxes[..., 4] * 0.5
    r1x = -hw * c - hh * s
    r1y = -hw * s + hh * c
    r2x = hw * c - hh * s
    r2y = hw * s + hh * c
    radius = torch.sqrt(hw * hw + hh * hh)
    area = boxes[..., 3] * boxes[..., 4] * boxes[..., 4]
    return torch.stack([boxes[..., 0], boxes[..., 1], r1x, r1y, r2x, r2y,
                        radius, area], dim=-1)


def _edge_term(ax, ay, bx, by, i: int, tie_pass: bool) -> torch.Tensor:
    """Edge i of A clipped to B by Liang-Barsky: its term of the boundary
    integral; ax/ay, bx/by: 4-lists of vertex coordinates, already
    recentred per pair."""
    sx = ax[i]
    sy = ay[i]
    dex = ax[(i + 1) % 4] - sx
    dey = ay[(i + 1) % 4] - sy
    t0 = torch.zeros_like(sx)
    t1 = torch.ones_like(sx)
    ok = torch.ones(sx.shape, dtype=torch.bool, device=sx.device)
    for h in range(4):
        px = bx[h]
        py = by[h]
        dx = bx[(h + 1) % 4] - px
        dy = by[(h + 1) % 4] - py
        a = dx * (sy - py) - dy * (sx - px)
        b = dx * dey - dy * dex
        tt = -a / torch.where(b == 0.0, 1.0, b)
        t0 = torch.where(b < 0.0, torch.maximum(t0, tt), t0)
        t1 = torch.where(b > 0.0, torch.minimum(t1, tt), t1)
        para_out = (b == 0.0) & (a > 0.0)
        if tie_pass:
            same_dir = dx * dex + dy * dey >= 0.0
            para_out = para_out | ((b == 0.0) & (a == 0.0) & same_dir)
        ok = ok & ~para_out
    p0x = sx + t0 * dex
    p0y = sy + t0 * dey
    p1x = sx + t1 * dex
    p1y = sy + t1 * dey
    return torch.where(ok & (t1 > t0), p0x * p1y - p0y * p1x, 0.0)


def _pair_integral(ax, ay, bx, by, tie_pass: bool) -> torch.Tensor:
    """Boundary integral of A's edges clipped to B: the edge terms summed
    in order, ((c0 + c1) + c2) + c3."""
    total = None
    for i in range(4):
        contrib = _edge_term(ax, ay, bx, by, i, tie_pass)
        total = contrib if total is None else total + contrib
    return total


def _recentred(det8: torch.Tensor, trk8: torch.Tensor):
    """Each pair's two quads around the midpoint of their centres, as
    vertex = offset +- half the centre delta: (ax, ay, bx, by), 4-lists
    broadcast from det8 [..., 8] against trk8 [..., 8]."""
    ddx = det8[..., 0] - trk8[..., 0]  # centre delta (a - b)
    ddy = det8[..., 1] - trk8[..., 1]
    hx = 0.5 * ddx  # a_centre - midpoint; b_centre - midpoint = -hx
    hy = 0.5 * ddy
    a_r1x, a_r1y, a_r2x, a_r2y = (det8[..., k] for k in range(2, 6))
    b_r1x, b_r1y, b_r2x, b_r2y = (trk8[..., k] for k in range(2, 6))
    return ([hx + a_r1x, hx + a_r2x, hx - a_r1x, hx - a_r2x],
            [hy + a_r1y, hy + a_r2y, hy - a_r1y, hy - a_r2y],
            [b_r1x - hx, b_r2x - hx, -b_r1x - hx, -b_r2x - hx],
            [b_r1y - hy, b_r2y - hy, -b_r1y - hy, -b_r2y - hy])


def _iou(inter, area_a, area_b):
    # union > 0: a degenerate (zero-area) box near a real one clips to the
    # real box's area and leaves the union at +-1 ulp of zero; in exact
    # math inter <= union, so the guard fires only on such rows
    union = area_a + area_b - inter
    pos = (inter > 0.0) & (union > 0.0)
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def far_pairs(det8: torch.Tensor, trk8: torch.Tensor) -> torch.Tensor:
    """[S?, D, T] bool: pairs whose enclosing circles do not meet."""
    ddx = det8[..., :, 0:1] - trk8[..., None, :, 0]
    ddy = det8[..., :, 1:2] - trk8[..., None, :, 1]
    md = det8[..., :, 6:7] + trk8[..., None, :, 6]
    return ddx * ddx + ddy * ddy > md * md


def tiles_to_run(far: torch.Tensor) -> torch.Tensor:
    """Number of TILE x TILE tiles of the [D, T] pair matrix that hold a
    pair in radius: the tiles whose clip the kernel runs."""
    d, t = far.shape
    dp, tp = -(-d // TILE) * TILE, -(-t // TILE) * TILE
    padded = torch.ones((dp, tp), dtype=torch.bool, device=far.device)
    padded[:d, :t] = far
    near = ~padded.reshape(dp // TILE, TILE, tp // TILE, TILE)
    return near.any(dim=3).any(dim=1).sum()


def pair_block_plain(det8: torch.Tensor, trk8: torch.Tensor,
                     want_iou: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: det8 [S?, D, 8], trk8
    [S?, T, 8] -> [S?, D, T] IoU (want_iou) or intersection area, 0 where
    empty or too far.  Same arithmetic and operation order as the kernel."""
    far = far_pairs(det8, trk8)
    ax, ay, bx, by = _recentred(det8[..., :, None, :], trk8[..., None, :, :])
    s = (_pair_integral(ax, ay, bx, by, False)
         + _pair_integral(bx, by, ax, ay, True))
    inter = torch.where(far, 0.0, torch.abs(s) * 0.5)
    if not want_iou:
        return inter
    return _iou(inter, det8[..., :, 7:8], trk8[..., None, :, 7])


def tile_count(s: int, d: int, t: int) -> int:
    """TILE x TILE tiles of S scenes' [D, T] pair matrices."""
    return s * -(-d // TILE) * -(-t // TILE)


def _check(det8: torch.Tensor, trk8: torch.Tensor, tiles) -> None:
    for name, x in (("det8", det8), ("trk8", trk8)):
        if x.dim() not in (2, 3) or x.shape[-1] != 8:
            raise ValueError(f"{name} must be [S?, N, 8], got "
                             f"{tuple(x.shape)}")
        if x.dtype != _F32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if det8.dim() != trk8.dim() or det8.shape[:-2] != trk8.shape[:-2]:
        raise ValueError(f"det8 {tuple(det8.shape)} and trk8 "
                         f"{tuple(trk8.shape)} must have the same scenes")
    if trk8.device != det8.device:
        raise ValueError("det8 and trk8 must be on one device")
    if tiles is not None and (tiles.shape != (1,) or tiles.dtype != torch.int32
                              or tiles.device != det8.device):
        raise ValueError("tiles must be an int32 [1] tensor on the inputs' "
                         "device")


def clip_pairs(det8: torch.Tensor, trk8: torch.Tensor, want_iou: bool,
               tiles=None) -> torch.Tensor:
    """[S?, D, T] rotated IoU (want_iou) or intersection area from clip
    columns det8 [S?, D, 8] and trk8 [S?, T, 8].  CUDA tensors launch the
    kernel once over every scene, CPU tensors run `pair_block_plain` scene
    by scene.  `tiles`, an optional int32 [1] tensor on the same device,
    is increased by the number of tiles whose clip ran."""
    _check(det8, trk8, tiles)
    if det8.dim() == 2:
        return _clip_scenes(det8[None], trk8[None], want_iou, tiles)[0]
    return _clip_scenes(det8, trk8, want_iou, tiles)


def _clip_scenes(det8, trk8, want_iou, tiles) -> torch.Tensor:
    s, d, t = det8.shape[0], det8.shape[1], trk8.shape[1]
    traced = tiles is None and recording()
    if traced:
        tiles = torch.zeros(1, dtype=torch.int32, device=det8.device)
    if det8.device.type == "cpu":
        out = det8.new_empty((s, d, t))
        for k in range(s):
            out[k] = pair_block_plain(det8[k], trk8[k], want_iou)
            if tiles is not None:
                tiles += tiles_to_run(far_pairs(det8[k], trk8[k])).to(
                    torch.int32)
    elif det8.device.type == "cuda":
        out = _launch(det8, trk8, want_iou, tiles)
    else:
        raise ValueError(f"unsupported device {det8.device}")
    if traced:
        keep("clip.tiles_run", tiles)
        keep("clip.tiles", torch.tensor([tile_count(s, d, t)]))
    return out


def _launch(det8, trk8, want_iou, tiles) -> torch.Tensor:
    from .._build import check, library

    lib = library()
    det8, trk8 = det8.contiguous(), trk8.contiguous()
    s, d, t = det8.shape[0], det8.shape[1], trk8.shape[1]
    out = torch.empty((s, d, t), dtype=_F32, device=det8.device)
    with torch.cuda.device(det8.device):
        code = lib.clip_pairs_launch(
            ctypes.c_void_p(det8.data_ptr()), ctypes.c_void_p(trk8.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(None if tiles is None else tiles.data_ptr()),
            s, d, t, d * 8, t * 8, d * t, int(want_iou), ctypes.c_void_p(
                torch.cuda.current_stream(det8.device).cuda_stream))
    check(code, "clip_pairs_launch")
    count("clip.launches")
    return out


def oriented_iou_blockskip(det_box: torch.Tensor, trk_box: torch.Tensor,
                           tiles=None):
    """Pairwise rotated IoU det[S?, D, 5] x trk[S?, T, 5] -> (iou[S?, D, T],
    valid[S?, D, T]).  Degenerate (zero-area) rows come out exactly 0/invalid;
    callers still mask padded rows and columns."""
    iou = clip_pairs(clip_columns(det_box), clip_columns(trk_box), True, tiles)
    return iou, iou > 0.0


def oriented_inter_blockskip(det_box: torch.Tensor, trk_box: torch.Tensor,
                             tiles=None) -> torch.Tensor:
    """Pairwise rotated intersection area (NMS needs inter / area_j, not
    the IoU)."""
    return clip_pairs(clip_columns(det_box), clip_columns(trk_box), False,
                      tiles)
