"""The exact host LAP solver (`csrc/lap.cpp`) on numpy arrays (mirrors the
JAX package's `native.lap_max` / `native.lap_max_batch`).

Maximisation: weights [R, C] with R <= C give one column per row.  The
library builds on first use with the system C++ compiler
(`_build.py::host_library`); where it cannot build, these raise
RuntimeError with the compiler's output.  There is no scipy fallback:
`assignment="hungarian"` is the caller's explicit choice.
"""

from __future__ import annotations

import numpy as np

from .. import _build


def lap_max(weights: np.ndarray) -> np.ndarray:
    """Exact maximisation LAP: weights [R, C] (R <= C) -> column per row
    [R] int32."""
    lib = _build.host_library()
    w = np.ascontiguousarray(weights, np.float32)
    r, c = w.shape
    out = np.zeros((r,), np.int32)
    err = lib.lap_solve_max(w.ctypes.data, r, c, out.ctypes.data)
    if err:
        raise RuntimeError(f"lap_solve_max failed: {err}")
    return out


def lap_max_batch(weights: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Batched exact LAP: weights [B, R, C] -> columns [B, R] int32, the
    problems spread over `n_threads` threads (0: one per core)."""
    lib = _build.host_library()
    w = np.ascontiguousarray(weights, np.float32)
    b, r, c = w.shape
    out = np.zeros((b, r), np.int32)
    err = lib.lap_solve_batch_max(w.ctypes.data, b, r, c, out.ctypes.data,
                                  n_threads)
    if err:
        raise RuntimeError(f"lap_solve_batch_max failed: {err}")
    return out
