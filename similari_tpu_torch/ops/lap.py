"""The exact host LAP solver (`csrc/lap.cpp`) on numpy arrays (mirrors the
JAX package's `native.lap_max` / `native.lap_max_batch`; bound in
`native.py`).

Maximisation: weights [R, C] with R <= C give one column per row.  The
library builds on first use with the system C++ compiler
(`_build.py::host_library`); where it cannot build, these raise
RuntimeError with the compiler's output.  There is no scipy fallback:
`assignment="hungarian"` is the caller's explicit choice.
"""

from __future__ import annotations

from ..native import lap_max, lap_max_batch

__all__ = ["lap_max", "lap_max_batch"]
