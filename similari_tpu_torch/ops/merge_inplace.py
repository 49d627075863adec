"""In-place batched row merge for the gallery lanes and the feature history
(mirrors `similari_tpu/ops/pallas_merge.py`).

    state[s, row[s, d]] <- src[s, d]   where valid[s, d] != 0

`lane_merge_inplace` launches the CUDA kernel `lane_merge_kernel`
(`csrc/merge.cu`) for CUDA tensors and runs its plain PyTorch version,
`lane_merge_plain`, for CPU tensors.  Both write `state` in place and
return it: this replaces the JAX package's donated, aliased buffer, so
only the written rows move, instead of a whole-array copy per write.
Rows outside [0, R) are never written.  Rows are unique within a scene
(track slots are).  Any feature width works for f32, bf16 and int32: the
TPU kernel's `F % 256` rule for bf16 was a Mosaic tiling limit.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count

_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _check(state, src, row, valid) -> None:
    if state.dim() != 3 or src.dim() != 3:
        raise ValueError(f"state must be [S, R, F] and src [S, D, F], got "
                         f"{tuple(state.shape)} and {tuple(src.shape)}")
    s, _, f = state.shape
    d = src.shape[1]
    if src.shape[0] != s or src.shape[2] != f:
        raise ValueError(f"src {tuple(src.shape)} does not fit state "
                         f"{tuple(state.shape)}")
    for name, x in (("row", row), ("valid", valid)):
        if x.shape != (s, d):
            raise ValueError(f"{name} must be [{s}, {d}], got "
                             f"{tuple(x.shape)}")
    if state.dtype not in _DTYPES:
        raise TypeError(f"state dtype {state.dtype}: float32, bfloat16 or "
                        "int32")
    if src.dtype != state.dtype:
        raise TypeError(f"src is {src.dtype}, state {state.dtype}")
    if row.dtype != torch.int32 or valid.dtype != torch.int32:
        raise TypeError("row and valid must be int32")
    if len({x.device for x in (state, src, row, valid)}) != 1:
        raise ValueError("state, src, row and valid must be on one device")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous: it is written in place")


def lane_merge_plain(state: torch.Tensor, src: torch.Tensor,
                     row: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: writes `state` in place and
    returns it."""
    s, r, f = state.shape
    ok = (valid != 0) & (row >= 0) & (row < r)
    scene, det = ok.nonzero(as_tuple=True)
    state.view(s * r, f)[scene * r + row[scene, det].long()] = src[scene, det]
    return state


def lane_merge_inplace(state: torch.Tensor, src: torch.Tensor,
                       row: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Write rows src[S, D, F] into state[S, R, F] in place at row[S, D]
    (int32) where valid[S, D] (int32) is not 0, and return `state` (the
    same tensor).  `state` must be contiguous; pass a `.view` of a larger
    state, never a reshaped copy, or the write is lost.  CUDA tensors
    launch the kernel (no host sync, no allocation), CPU tensors run
    `lane_merge_plain`."""
    _check(state, src, row, valid)
    if state.device.type == "cpu":
        return lane_merge_plain(state, src, row, valid)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    from .._build import check, library

    lib = library()
    src, row, valid = src.contiguous(), row.contiguous(), valid.contiguous()
    s, r, f = state.shape
    with torch.cuda.device(state.device):
        code = lib.lane_merge_launch(
            ctypes.c_void_p(state.data_ptr()), ctypes.c_void_p(src.data_ptr()),
            ctypes.c_void_p(row.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
            s, src.shape[1], r, f * state.element_size(), ctypes.c_void_p(
                torch.cuda.current_stream(state.device).cuda_stream))
    check(code, "lane_merge_launch")
    count("merge_inplace.launches")
    return state
