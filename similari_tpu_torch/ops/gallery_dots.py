"""The gallery products of one fused VisualSORT chunk.

Within a chunk of C frames the fused scan writes a gallery lane only by
copying a candidate's feature row of the chunk into it, so every lane a
frame-s candidate can meet holds its value at the start of the chunk or
the row of a candidate of an earlier frame.  Every dot product the scan
can need is therefore an entry of one product, computed before the scan:

    dots[N, M + N] = X @ [G ; X].T

with X = feat f32[N = C*D, F] (chunk row s*D + r) and G = the gallery at
the start of the chunk, f32[M = T*K, F] (lane t*K + i): column j < M is
launch-start lane j, column M + x is chunk row x.  `norms[M + N]` holds the
f32 sum of squares of each column's row.  With bf16 distance inputs both
operands are rounded to bf16 and multiplied with f32 sums; the norms are
always those of the unrounded values (`similari_tpu/ops/pallas_visual.py`
:245-265).

`gallery_dots` launches the CUDA kernels of `csrc/gallery_dots.cu` for
CUDA tensors, which skip the tiles the scan never reads (outside
`needed_columns`), and runs their plain version, `gallery_dots_plain`, for
CPU tensors.  With bf16 inputs a staging kernel first writes the norms and
a bf16 copy of [G ; X] (rows rounded once, zero-padded to PAD columns),
then a TMA + wgmma kernel multiplies that copy in TILE_ROWS x TILE_COLS
output tiles (`tests/kernel_replay.py` replays both on the CPU).  f32
inputs take one kernel of exact f32 products.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, spanned

_F32 = torch.float32
# the bf16 copy's row width is a multiple of this (`csrc/gallery_dots.cu`
# KT: TMA needs 16-byte row strides, wgmma a depth of 16, a stage is 64
# deep); the bf16 product's output tile
PAD = 64
TILE_ROWS, TILE_COLS = 192, 256


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even) and back to f32,
    as ml_dtypes and XLA round: a NaN comes back as the quiet NaN of its
    sign (torch's own conversion gives every NaN the bits 0xFFFF)."""
    r = x.to(torch.bfloat16).to(_F32)
    return torch.where(torch.isnan(x),
                       torch.copysign(torch.full_like(r, float("nan")), x), r)


def f32_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in plain f32: TF32 would round the gallery product to ~3
    digits."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def gallery_dots_plain(x: torch.Tensor, g: torch.Tensor, bf16: bool):
    """(dots f32[N, M + N], norms f32[M + N]) for chunk rows x f32[N, F]
    and launch-start lanes g f32[M, F], every entry computed; f32 products
    on bf16-rounded operands when `bf16`."""
    cols = torch.cat([g, x])
    norms = (cols * cols).sum(dim=1)
    if bf16:
        x, cols = round_bf16(x), round_bf16(cols)
    return f32_dots(x, cols), norms


def needed_columns(n: int, m: int, rows_per_frame: int,
                   device=None) -> torch.Tensor:
    """bool [N, M + N]: the entries the scan can read.  Every launch-start
    lane, and chunk row x' for chunk row x only when x' is of an earlier
    frame."""
    frame = torch.arange(n, device=device) // rows_per_frame
    return torch.cat([torch.ones((n, m), dtype=torch.bool, device=device),
                      frame[:, None] > frame[None, :]], dim=1)


@spanned("gallery_dots")
def gallery_dots(x: torch.Tensor, g: torch.Tensor, bf16: bool,
                 rows_per_frame: int):
    """(dots f32[N, M + N], norms f32[M + N]) for chunk rows x f32[N, F]
    (`rows_per_frame` rows per frame) and launch-start lanes g f32[M, F].

    CUDA tensors launch the kernels, which may leave the entries outside
    `needed_columns` unwritten; CPU tensors run `gallery_dots_plain`, which
    computes them all.
    """
    if x.dim() != 2 or g.dim() != 2 or x.shape[1] != g.shape[1]:
        raise ValueError("x must be [N, F] and g [M, F]")
    if x.dtype != _F32 or g.dtype != _F32:
        raise TypeError("x and g must be float32")
    if x.device != g.device:
        raise ValueError("x and g must lie on one device")
    n, f = x.shape
    m = g.shape[0]
    if n < 1 or m < 1 or f < 1 or rows_per_frame < 1 or n % rows_per_frame:
        raise ValueError("empty operands, or N not a multiple of the rows "
                         "per frame")
    if x.device.type == "cpu":
        return gallery_dots_plain(x, g, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from .._build import check, library

    lib = library()
    x, g = x.contiguous(), g.contiguous()
    dev = x.device
    dots = torch.empty((n, m + n), dtype=_F32, device=dev)
    norms = torch.empty((m + n,), dtype=_F32, device=dev)
    # the bf16 staging kernel's rounded, padded copy of [G ; X]
    stage = (torch.empty((m + n, -(-f // PAD) * PAD), dtype=torch.bfloat16,
                         device=dev) if bf16 else None)
    with torch.cuda.device(dev):  # the launches and their attributes
        code = lib.gallery_dots_launch(
            x.data_ptr(), g.data_ptr(), dots.data_ptr(), norms.data_ptr(),
            None if stage is None else stage.data_ptr(), n, m, f,
            rows_per_frame, int(bf16),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(code, "gallery_dots_launch")
    count("gallery_dots.launches")
    return dots, norms
