"""Build the port's native libraries on first use and bind them with ctypes.

Two libraries, both written to `_build/` beside this file (listed in
.gitignore) and named by a hash of their sources and flags, so an edited
source rebuilds:

* the CUDA kernels (`library()`): each `.cu` source under `csrc/` compiles
  to an object file, all of them in parallel (one nvcc each, started
  together), and the objects link into one shared library with a plain C
  interface.  It builds on a machine with the CUDA toolkit.
* the host library (`host_library()`): the C++ sources under `csrc/`
  (`HOST_SOURCES`: the LAP solver, the MOT csv loader, the native SORT and
  VisualSORT steps with the Kalman sequences and the rotated IoU, NMS) in
  one command of the system C++ compiler (`$CXX`, else `c++`) with the
  JAX package's native flags, so its results are the JAX package's bit
  for bit.  It builds wherever a C++ compiler is, the CPU included; a
  failed build raises.  `native.py` and `ops/lap.py` bind it.

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
SOURCES = ("fused_track.cu", "gallery_dots.cu", "clip.cu", "merge.cu",
           "visual_votes.cu", "auction.cu")
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
# fused_visual_plan: D, T, K; plan[4]
VISUAL_PLAN_ARGTYPES = [_I, _I, _I, ctypes.POINTER(_I)]
VISUAL_ARGTYPES = ([_P] * (7 + 20 + 8 + 2 + 2) + [_I] * 13 + [_F] * 12
                   + [_P, _P, _P] + [_P])
# csrc/gallery_dots.cu: x, g, dots, norms, bf16 staging; n, m, f, d, bf16;
# stream
DOTS_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]
# csrc/clip.cu: det8, trk8, out, tiles_run; s, d, t; the three per-scene
# strides; want_iou; stream
CLIP_ARGTYPES = [_P] * 4 + [_I] * 3 + [ctypes.c_longlong] * 3 + [_I, _P]
# csrc/merge.cu: state, src, row, valid; s, d, r; row bytes; stream
MERGE_ARGTYPES = [_P] * 4 + [_I] * 3 + [ctypes.c_longlong] + [_P]
# csrc/visual_votes.cu: dot, qn, gn, five gates, four outputs, column-key
# scratch; compat's two strides; s, d, t, k, kind, min votes; threshold;
# the plan's cluster size, storage bits and shared bytes; stream
VOTES_ARGTYPES = ([_P] * 13 + [ctypes.c_longlong] * 2 + [_I] * 6 + [_F]
                  + [_I] * 3 + [_P])
# visual_votes_plan: s, d, t, column scratch given; plan[3]
VOTES_PLAN_ARGTYPES = [_I] * 4 + [ctypes.POINTER(_I)]
# csrc/auction.cu: weights, row and column valid, out, scene rounds,
# rounds counter, column scratch; s, d, t, cap, min rounds; theta, 1 / div;
# the plan's threads, lanes, storage and shared bytes; vec; stream
AUCTION_ARGTYPES = [_P] * 7 + [_I] * 5 + [_F] * 2 + [_I] * 5 + [_P]
# auction_fb_plan: s, d, t; plan[4]
AUCTION_PLAN_ARGTYPES = [_I] * 3 + [ctypes.POINTER(_I)]


# the host library's sources and headers, with the flags of the JAX
# package's native build
HOST_SOURCES = ("lap.cpp", "motloader.cpp", "sortstep.cpp", "nms.cpp",
                "visualstep.cpp")
HOST_HEADERS = ("kf.h", "clip.h")
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread")
_L = ctypes.c_int64
# (restype, argtypes) of every export of the host library; pointers are
# passed as addresses (`ndarray.ctypes.data`)
HOST_EXPORTS = {
    # weights, R, C, out
    "lap_solve_max": (_I, [_P, _I, _I, _P]),
    # weights, B, R, C, out, threads
    "lap_solve_batch_max": (_I, [_P, _I, _I, _I, _P, _I]),
    # csrc/motloader.cpp: path -> handle; dims[3]; frames; box, conf, valid
    "mot_load": (_P, [ctypes.c_char_p]),
    "mot_dims": (None, [_P, ctypes.POINTER(_L)]),
    "mot_frames": (None, [_P, _P]),
    "mot_fill": (None, [_P, _P, _P, _P]),
    "mot_free": (None, [_P]),
    # csrc/sortstep.cpp: method, oriented; iou threshold, min confidence,
    # max idle; position, velocity weights, new-track threshold;
    # constraints, their count; the Kalman state (5); pred, obs box; conf,
    # active, last epoch, length, track id; histories (3); T, H, next id;
    # det box, det conf, D, epoch; outputs (6)
    "sort_step_host": (_I, [_I, _I, _F, _F, _I, _F, _F, _F, _P, _I]
                       + [_P] * 15 + [_I] * 3 + [_P, _P, _I, _I]
                       + [_P] * 6),
    # z, N, position weight, velocity weight, out
    "kf_box_sequence": (_I, [_P, _I, _F, _F, _P]),
    # z, N, P, position weight, velocity weight, out
    "kf_point_sequence": (_I, [_P, _I, _I, _F, _F, _P]),
    # a, b, n, out
    "rotated_iou_pairs": (_I, [_P, _P, _I, _P]),
    # csrc/nms.cpp: boxes, n, threshold, oriented, keep; the batch with B
    "nms_host": (_I, [_P, _I, _F, _I, _P]),
    "nms_host_batch": (_I, [_P, _I, _I, _F, _I, _P]),
    # csrc/visualstep.cpp: float and int config, constraints; the Kalman
    # state (5); pred, obs, conf; active, last epoch, length, track id;
    # the gallery (5); histories (5); T, H, K, F, next id; detections (6);
    # dmat, its columns, D, epoch; outputs (7)
    "visual_step_host": (_I, [_P] * 25 + [_I] * 5 + [_P] * 7
                         + [_I] * 3 + [_P] * 7),
}


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
        lib.visual_votes_launch.argtypes = VOTES_ARGTYPES
        lib.visual_votes_launch.restype = ctypes.c_int
        lib.visual_votes_plan.argtypes = VOTES_PLAN_ARGTYPES
        lib.visual_votes_plan.restype = ctypes.c_int
        lib.auction_fb_launch.argtypes = AUCTION_ARGTYPES
        lib.auction_fb_launch.restype = ctypes.c_int
        lib.auction_fb_plan.argtypes = AUCTION_PLAN_ARGTYPES
        lib.auction_fb_plan.restype = ctypes.c_int
        lib.auction_fb_scratch_bytes.argtypes = [_I, _I]
        lib.auction_fb_scratch_bytes.restype = ctypes.c_longlong
        _LIB.lib = lib
    return _LIB.lib


def build_info():
    """(seconds the last nvcc run took in this process, its output)."""
    return _LIB.build_seconds, _LIB.build_log


def _cxx() -> str:
    return os.environ.get("CXX") or "c++"


def build_host() -> Path:
    """Compile the host library if this exact source set, compiler and
    flag set is not built yet.  Raises RuntimeError with the compiler's
    command and output."""
    cxx = _cxx()
    # -march=native: the machine is part of the name, as in the JAX
    # package's build
    h = hashlib.sha256(" ".join((cxx, platform.machine()) + HOST_FLAGS)
                       .encode())
    for name in HOST_SOURCES + HOST_HEADERS:
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libsimilari_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *HOST_FLAGS, "-I", str(CSRC),
           *(str(CSRC / s) for s in HOST_SOURCES), "-o", str(tmp)]
    hint = ("set CXX to a C++ compiler: the host engines, the MOT file "
            "loader, the Kalman sequences and NMS on the CPU need it, and "
            "the LAP solver unless assignment='hungarian'")
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the host library did not build "
                           f"({' '.join(cmd)}): {e}; {hint}") from e
    finally:
        _HOST.build_seconds = time.perf_counter() - t0
    _HOST.build_log = res.stdout
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the host library did not build ({' '.join(cmd)}, exit "
            f"{res.returncode}); {hint}:\n{res.stdout}")
    os.replace(tmp, out)
    return out


def host_library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    if _HOST.lib is None:
        lib = ctypes.CDLL(str(build_host()))
        for name, (restype, argtypes) in HOST_EXPORTS.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _HOST.lib = lib
    return _HOST.lib


def host_build_info():
    """(seconds the last C++ build took in this process, its output)."""
    return _HOST.build_seconds, _HOST.build_log


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
