"""Build the port's native libraries on first use and bind them with ctypes.

Two libraries, both written to `_build/` beside this file (listed in
.gitignore) and named by a hash of their sources and flags, so an edited
source rebuilds:

* the CUDA kernels (`library()`): each `.cu` source under `csrc/` compiles
  to an object file, all of them in parallel (one nvcc each, started
  together), and the objects link into one shared library with a plain C
  interface.  It builds on a machine with the CUDA toolkit.
* the host LAP solver (`host_library()`, `csrc/lap.cpp`): the system C++
  compiler (`$CXX`, else `c++`) with the JAX package's native flags, so
  its solutions are the JAX package's bit for bit.  It builds wherever a
  C++ compiler is, the CPU included; a failed build raises.

Nothing here runs at import time.  A build writes a temporary file named
by the process id and moves it into place, so concurrent first builds
(parallel test workers) never interleave.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_track.cu", "gallery_dots.cu", "clip.cu", "merge.cu")
HEADERS = ("fused_track.cuh",)
# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum exactly as their plain PyTorch versions do, and the clip
# kernel's exact collinear tests hold
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument lists of the C launchers in csrc/fused_track.cu
# (inputs, state, outputs, scratch pointers; ints; floats; constraint
# tables for the visual kernel; the phase stamps; stream)
SORT_ARGTYPES = [_P] * (3 + 13 + 5 + 2) + [_I] * 6 + [_F] * 6 + [_P, _P]
# fused_sort_plan: D, T; plan[4]
SORT_PLAN_ARGTYPES = [_I, _I, ctypes.POINTER(_I)]
# fused_visual_plan: D, T, K; plan[2]
VISUAL_PLAN_ARGTYPES = [_I, _I, _I, ctypes.POINTER(_I)]
VISUAL_ARGTYPES = ([_P] * (7 + 20 + 8 + 5 + 2) + [_I] * 13 + [_F] * 12
                   + [_P, _P, _P] + [_P])
# csrc/gallery_dots.cu: x, g, dots, norms, bf16 staging; n, m, f, d, bf16;
# stream
DOTS_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]
# csrc/clip.cu: det8, trk8, out, tiles_run; d, t, want_iou; stream
CLIP_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]
# csrc/merge.cu: state, src, row, valid; s, d, r; row bytes; stream
MERGE_ARGTYPES = [_P] * 4 + [_I] * 3 + [ctypes.c_longlong] + [_P]


# csrc/lap.cpp: the flags of the JAX package's native build
HOST_SOURCE = "lap.cpp"
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread")
# lap_solve_max: weights, R, C, out; lap_solve_batch_max: weights, B, R, C,
# out, threads
LAP_ARGTYPES = [_P, _I, _I, _P]
LAP_BATCH_ARGTYPES = [_P, _I, _I, _I, _P, _I]


class _Library:
    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0
        self.build_log = ""


_LIB = _Library()
_HOST = _Library()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; raise with their output if any fails.
    Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {'; '.join(failed)}\n{log}")
    return log


def build() -> Path:
    """Compile the library if this exact source is not built yet."""
    digest = _digest()
    out = BUILD_DIR / f"libsimilari_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                         str(CSRC / s)] for s, o in zip(SOURCES, objs)])
        # -ldl: gallery_dots.cu looks up the driver's TMA encoder at run
        # time (dlopen), so the library links no driver stub
        log += _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                          *map(str, objs), "-ldl"]])
    finally:
        _LIB.build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
    _LIB.build_log = log
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _LIB.lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fused_sort_launch.argtypes = SORT_ARGTYPES
        lib.fused_sort_launch.restype = ctypes.c_int
        lib.fused_sort_plan.argtypes = SORT_PLAN_ARGTYPES
        lib.fused_sort_plan.restype = ctypes.c_int
        lib.fused_visual_plan.argtypes = VISUAL_PLAN_ARGTYPES
        lib.fused_visual_plan.restype = ctypes.c_int
        lib.fused_visual_launch.argtypes = VISUAL_ARGTYPES
        lib.fused_visual_launch.restype = ctypes.c_int
        lib.gallery_dots_launch.argtypes = DOTS_ARGTYPES
        lib.gallery_dots_launch.restype = ctypes.c_int
        lib.clip_pairs_launch.argtypes = CLIP_ARGTYPES
        lib.clip_pairs_launch.restype = ctypes.c_int
        lib.lane_merge_launch.argtypes = MERGE_ARGTYPES
        lib.lane_merge_launch.restype = ctypes.c_int
        _LIB.lib = lib
    return _LIB.lib


def build_info():
    """(seconds the last nvcc run took in this process, its output)."""
    return _LIB.build_seconds, _LIB.build_log


def _cxx() -> str:
    return os.environ.get("CXX") or "c++"


def build_host() -> Path:
    """Compile `csrc/lap.cpp` if this exact source, compiler and flag set
    is not built yet.  Raises RuntimeError with the compiler's output."""
    cxx = _cxx()
    # -march=native: the machine is part of the name, as in the JAX
    # package's build
    h = hashlib.sha256(" ".join((cxx, platform.machine()) + HOST_FLAGS)
                       .encode())
    h.update((CSRC / HOST_SOURCE).read_bytes())
    out = BUILD_DIR / f"libsimilari_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *HOST_FLAGS, str(CSRC / HOST_SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(
            f"the host LAP solver did not build ({' '.join(cmd)}): {e}; "
            "set CXX to a C++ compiler, or use assignment='hungarian'") from e
    finally:
        _HOST.build_seconds = time.perf_counter() - t0
    _HOST.build_log = res.stdout
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the host LAP solver did not build ({' '.join(cmd)}, exit "
            f"{res.returncode}); use assignment='hungarian' where no C++ "
            f"compiler is available:\n{res.stdout}")
    os.replace(tmp, out)
    return out


def host_library() -> ctypes.CDLL:
    """The loaded host LAP library (`csrc/lap.cpp`), built on first use."""
    if _HOST.lib is None:
        lib = ctypes.CDLL(str(build_host()))
        lib.lap_solve_max.argtypes = LAP_ARGTYPES
        lib.lap_solve_max.restype = ctypes.c_int
        lib.lap_solve_batch_max.argtypes = LAP_BATCH_ARGTYPES
        lib.lap_solve_batch_max.restype = ctypes.c_int
        _HOST.lib = lib
    return _HOST.lib


def host_build_info():
    """(seconds the last C++ build took in this process, its output)."""
    return _HOST.build_seconds, _HOST.build_log


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
