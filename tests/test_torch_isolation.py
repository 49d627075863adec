"""The port imports neither JAX nor the JAX package.

A fresh interpreter is needed for the import check: this test process has
imported both already (tests/conftest.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "similari_tpu_torch"
# the JAX package, and the JAX package's benchmark scripts at the root
FORBIDDEN = ("jax", "jaxlib", "similari_tpu", "bench", "bench_interactive")


def _forbidden(name: str) -> bool:
    # exact name or a dotted submodule: `similari_tpu_torch` is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    for m in ("similari_tpu_torch.ops.fused_visual",
              "similari_tpu_torch.ops.gallery_dots",
              "similari_tpu_torch.ops.merge_inplace",
              "similari_tpu_torch.ops.ownarea",
              "similari_tpu_torch.parallel.mesh",
              "similari_tpu_torch.utils.bbox",
              "similari_tpu_torch.utils.clipping",
              "similari_tpu_torch.utils.nms",
              "similari_tpu_torch.trackers.waste",
              "similari_tpu_torch.trackers.sort",
              "similari_tpu_torch.trackers.visual",
              "similari_tpu_torch.trackers.batch",
              "similari_tpu_torch.trackers.batch_device",
              "similari_tpu_torch.trackers.batch_visual_device",
              "similari_tpu_torch.trackers.host_sort",
              "similari_tpu_torch.trackers.host_visual",
              "similari_tpu_torch.trackers.host_geometry",
              "similari_tpu_torch.trackers.feature",
              "similari_tpu_torch.utils.kalman",
              "similari_tpu_torch.ops.lap",
              "similari_tpu_torch.native",
              "similari_tpu_torch.eval",
              "similari_tpu_torch.parallel.gallery",
              "similari_tpu_torch.parallel.handoff",
              "similari_tpu_torch.parallel.dryrun",
              "similari_tpu_torch.utils.checkpoint",
              "similari_tpu_torch.utils.profiling",
              "similari_tpu_torch.bench",
              "similari_tpu_torch.bench_interactive",
              "similari_tpu_torch.bench_pod",
              "similari_tpu_torch.tools.adversarial_suite",
              "similari_tpu_torch.tools.profile_gallery",
              "similari_tpu_torch.tools.profile_oriented",
              "similari_tpu_torch.tools.decision_margins",
              "similari_tpu_torch.tools.experiment_batch_merge",
              "similari_tpu_torch.tools.experiment_pallas_batch",
              "similari_tpu_torch.tools.ablate_visual",
              "similari_tpu_torch.tools.gen_doc_tables",
              "similari_tpu_torch.examples.cross_camera_handoff"):
        assert m in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_chip_smoke_import_leaves_jax_out_of_sys_modules():
    """chip_smoke.py and what it imports (the package, tests/torch_parity.py)
    run on a machine without JAX."""
    code = ("import sys\n"
            "import chip_smoke\n"
            "print(' '.join(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "torch_parity" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA is not available" in res.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "tests/torch_parity.py",
       "tests/torch_dist_worker.py"]))
def test_no_forbidden_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_library_of_the_jax_package_is_loaded(path):
    """The port loads only its own kernel library (`_build.py`), never the
    JAX package's native one by file path."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "similari_tpu/native" not in node.value, path
        if isinstance(node, ast.Attribute) and node.attr in ("CDLL",
                                                             "LoadLibrary"):
            assert path.endswith("_build.py"), f"{path}:{node.lineno}"


def test_public_api_import_leaves_jax_out_of_sys_modules():
    """The reference's top-level surface, imported from the package root."""
    code = (
        "import sys\n"
        "from similari_tpu_torch import (\n"
        "    Sort, VisualSort, BatchSort, BatchVisualSort, nms,\n"
        "    Universal2DBox, sutherland_hodgman_clip, intersection_area,\n"
        "    exclusively_owned_areas_normalized_shares, version,\n"
        "    FeatureTracker, Universal2DBoxKalmanFilter, Point2DKalmanFilter,\n"
        "    Vec2DKalmanFilter)\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert [m for m in res.stdout.split() if _forbidden(m)] == []


def test_parallel_import_leaves_jax_out_of_sys_modules():
    """The sharded paths and the rank worker of the sharded tests, which
    spawned processes import, load neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import similari_tpu_torch.parallel\n"
        "from similari_tpu_torch.utils import load_tracker, trace\n"
        "import torch_dist_worker\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "similari_tpu_torch.parallel.handoff" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_forbidden_matches_only_the_jax_package():
    assert _forbidden("similari_tpu") and _forbidden("similari_tpu.ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden("similari_tpu_torch")
    assert not _forbidden("similari_tpu_torch.ops.fused_sort")
    assert _forbidden("bench") and _forbidden("bench_interactive")
    assert not _forbidden("similari_tpu_torch.bench")
    assert not _forbidden("benchmark")
