"""The port is complete: every top-level function and class of each
`similari_tpu/` module, and every method of those classes, has a
counterpart of the same name in the port (`similari_tpu_torch/`).

Read with `ast` from the sources; neither package is imported.  A
counterpart is found in the port's module of the same path (or the
renamed module of `MODULES`), a method also in a base class the port
factored out (its bases are followed through every port module).  Names
without one are listed in `RENAMED`, which gives the counterpart under
another name (a port module or a CUDA / C++ source, checked to define
it), or in `JAX_ONLY`, which gives the reason the name is a form only the
JAX package needs.  A new JAX name with neither fails the test, and so
does an entry that no longer names a missing JAX name.

The repo's entry points (`examples/*.py`, `tools/*.py`, the root
`bench*.py`) each have a port module of the same path under
`similari_tpu_torch/` with a `main()`, or are the port's own tools
(`PORT_TOOLS`).  `PENDING`, the entry points still to port with the
ROADMAP item that will port each (an entry that gains a counterpart
fails), is empty: every entry point has its counterpart.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "similari_tpu"
PORT = ROOT / "similari_tpu_torch"

# JAX module -> the port module that holds its counterparts
MODULES = {
    "native/__init__.py": "native.py",
    "ops/pallas_clip.py": "ops/clip.py",
    "ops/pallas_merge.py": "ops/merge_inplace.py",
    "ops/pallas_sort.py": "ops/fused_sort.py",
    "ops/pallas_visual.py": "ops/fused_visual.py",
}

# JAX name -> "port file::name" of its counterpart under another name
RENAMED = {
    "native/__init__.py::_build_and_load":
        "similari_tpu_torch/_build.py::build_host",
    "native/__init__.py::_get_lib":
        "similari_tpu_torch/_build.py::host_library",
    "native/__init__.py::SortStepSession._outs":
        "similari_tpu_torch/native.py::_sort_outputs",
    "native/__init__.py::VisualStepSession._outs":
        "similari_tpu_torch/native.py::_visual_outputs",
    "ops/assignment.py::_auction_phase":
        "similari_tpu_torch/ops/assignment.py::_auction_lap",
    "ops/geometry.py::_cyclic_select":
        "similari_tpu_torch/ops/geometry.py::_cyclic_take",
    "ops/geometry.py::_sh_clip_quads_lp":
        "similari_tpu_torch/ops/geometry.py::_sh_clip_quads",
    "ops/geometry.py::_masked_area_lp":
        "similari_tpu_torch/ops/geometry.py::_masked_area",
    "ops/kalman.py::_box_stds": "similari_tpu_torch/ops/kalman.py::box_var",
    "ops/kalman.py::_point_stds":
        "similari_tpu_torch/ops/kalman.py::point_var",
    "ops/kalman.py::KalmanSpec._std_pos":
        "similari_tpu_torch/ops/kalman.py::KalmanSpec._var",
    "ops/kalman.py::KalmanSpec._std_vel":
        "similari_tpu_torch/ops/kalman.py::KalmanSpec._var",
    "ops/merge.py::merge_tree":
        "similari_tpu_torch/ops/kalman.py::scatter_state",
    "ops/merge.py::take_tree":
        "similari_tpu_torch/ops/kalman.py::gather_state",
    "ops/pallas_clip.py::_pair_block":
        "similari_tpu_torch/csrc/clip.cu::clip_pairs_kernel",
    "ops/pallas_merge.py::_merge_kernel":
        "similari_tpu_torch/csrc/merge.cu::lane_merge_kernel",
    "ops/pallas_sort.py::_row_argmax":
        "similari_tpu_torch/csrc/fused_track.cuh::warp_top2",
    "ops/pallas_sort.py::_cumsum_rows":
        "similari_tpu_torch/csrc/fused_track.cuh::block_scan_inclusive",
    "ops/pallas_sort.py::forward_auction":
        "similari_tpu_torch/csrc/fused_track.cuh::cluster_auction",
    "ops/pallas_sort.py::_kernel":
        "similari_tpu_torch/csrc/fused_track.cu::fused_sort_kernel",
    "ops/pallas_sort.py::pallas_sort_chunk":
        "similari_tpu_torch/ops/fused_sort.py::fused_sort_chunk",
    "ops/pallas_sort.py::compiled_pallas_sort_scan":
        "similari_tpu_torch/ops/fused_sort.py::fused_sort_scan",
    "ops/pallas_visual.py::_col_argmax":
        "similari_tpu_torch/csrc/fused_track.cuh::warp_argmax",
    "ops/pallas_visual.py::_kernel":
        "similari_tpu_torch/csrc/fused_track.cu::fused_visual_kernel",
    "ops/pallas_visual.py::pallas_visual_chunk":
        "similari_tpu_torch/ops/fused_visual.py::fused_visual_chunk",
    "ops/pallas_visual.py::compiled_pallas_visual_scan":
        "similari_tpu_torch/ops/fused_visual.py::fused_visual_scan",
    "parallel/handoff.py::_is_track_leaf":
        "similari_tpu_torch/parallel/handoff.py::_track_leaves",
    "parallel/handoff.py::_extract":
        "similari_tpu_torch/parallel/handoff.py::_rows",
    "parallel/handoff.py::_insert":
        "similari_tpu_torch/parallel/handoff.py::_write",
    "parallel/handoff.py::_source_onehot":
        "similari_tpu_torch/parallel/handoff.py::_find",
    "parallel/handoff.py::_psum_leaf":
        "similari_tpu_torch/parallel/mesh.py::all_reduce_sum",
    "parallel/handoff.py::_same_scene_rank":
        "similari_tpu_torch/parallel/handoff.py::track_migration",
    "trackers/batch_device.py::SceneBatchEngine._export":
        "similari_tpu_torch/trackers/batch_device.py::"
        "BatchEngineBase.collect_wasted",
    "trackers/batch_visual_device.py::VisualSceneBatchEngine._export":
        "similari_tpu_torch/trackers/batch_device.py::"
        "BatchEngineBase.collect_wasted",
    "trackers/sort.py::_box_from_row":
        "similari_tpu_torch/utils/bbox.py::Universal2DBox.from_vec5",
    "trackers/visual_step.py::_compat_matrix":
        "similari_tpu_torch/trackers/sort_step.py::_compat",
    "utils/checkpoint.py::_flatten_state":
        "similari_tpu_torch/utils/checkpoint.py::_leaves",
}

NO_JIT = "a jax.jit wrapper; the port has no jit and calls the step itself"
ONE_HOT = ("a one-hot contraction in place of a gather or scatter, which "
           "serialises on the TPU; the port indexes natively "
           "(ops/merge.py::write_index, take_rows)")
NO_FALLBACK = ("asks whether the C++ library built; the port's library "
               "builds or raises RuntimeError, with no path around it")
MESH_AXES = ("names the shards of a jax Mesh; a port Mesh's shard is its "
             "torch.distributed rank (parallel/mesh.py::Mesh)")

# JAX name -> why the port has no counterpart
JAX_ONLY = {
    "motchallenge/config.py::KitConfig.apply_platform":
        "sets JAX's backend for the process; the port passes `platform` "
        "to each tracker as its device (KitConfig.make_tracker)",
    "native/__init__.py::available": NO_FALLBACK,
    "native/__init__.py::sort_step_available": NO_FALLBACK,
    "native/__init__.py::nms_available": NO_FALLBACK,
    "native/__init__.py::visual_step_available": NO_FALLBACK,
    "ops/assignment.py::_native_np":
        "the numpy side of jax.pure_callback; the port's native_host calls "
        "native.lap_max directly",
    "ops/merge.py::_place": ONE_HOT,
    "ops/merge.py::merge_scalar": ONE_HOT,
    "ops/merge.py::reader_hit": ONE_HOT,
    "ops/merge.py::_use_onehot":
        "chooses between the one-hot and the gather forms by backend; the "
        "port has only the gather form",
    "ops/pallas_clip.py::_compiled_call": NO_JIT,
    "parallel/handoff.py::_mesh_axes": MESH_AXES,
    "parallel/handoff.py::_my_shard": MESH_AXES,
    "parallel/mesh.py::pod_scene_spec":
        "a PartitionSpec over the pod mesh's two axes; a port rank holds "
        "one block of scenes (shard_batched_state)",
    "trackers/batch_device.py::_compiled_batch_step": NO_JIT,
    "trackers/batch_visual_device.py::_compiled_batch_visual_step": NO_JIT,
    "trackers/sort.py::Sort._step_for":
        "picks the jitted step for the oriented flag; the port's tracker "
        "calls the step with its config",
    "trackers/visual.py::VisualSort._step_for":
        "picks the jitted step for the oriented flag; the port's tracker "
        "calls the step with its config",
    "trackers/sort_step.py::compiled_sort_step": NO_JIT,
    "trackers/sort_step.py::compiled_sort_scan": NO_JIT,
    "trackers/visual_step.py::compiled_visual_step": NO_JIT,
    "trackers/visual_step.py::compiled_visual_scan": NO_JIT,
}


def _defs(path: Path):
    """{top-level name: None for a function, (methods, base names) for a
    class}."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            out[node.name] = (
                {n.name for n in node.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))},
                [ast.unparse(b).split(".")[-1] for b in node.bases])
    return out


def _port_classes():
    classes = {}
    for path in PORT.rglob("*.py"):
        for name, v in _defs(path).items():
            if v is not None:
                classes.setdefault(name, []).append(v)
    return classes


def _methods(classes, name, seen=()):
    """The methods of port class `name` and of its bases."""
    out = set()
    for methods, bases in classes.get(name, []):
        out |= methods
        for b in bases:
            if b not in seen:
                out |= _methods(classes, b, seen + (name,))
    return out


def _missing():
    """JAX names ("module::name" or "module::Class.method") with no
    same-named counterpart in the port."""
    classes = _port_classes()
    missing = []
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX).as_posix()
        port = PORT / MODULES.get(rel, rel)
        have = _defs(port) if port.exists() else {}
        for name, v in _defs(path).items():
            if name not in have:
                missing.append(f"{rel}::{name}")
            elif v is not None:
                own = _methods(classes, name) if have[name] is not None \
                    else set()
                missing += [f"{rel}::{name}.{m}" for m in sorted(v[0])
                            if m not in own]
    return missing


def test_every_jax_name_is_ported_or_listed():
    missing = _missing()
    assert len(missing) > 30  # the walk found the modules
    unlisted = [m for m in missing if m not in RENAMED and m not in JAX_ONLY]
    assert not unlisted, ("JAX names with no counterpart in the port and "
                          f"no entry in RENAMED or JAX_ONLY: {unlisted}")


def test_table_entries_name_missing_jax_names():
    """No entry is stale, and none is in both tables."""
    missing = set(_missing())
    stale = [k for k in sorted(set(RENAMED) | set(JAX_ONLY))
             if k not in missing]
    assert not stale, f"entries that name no missing JAX name: {stale}"
    assert not set(RENAMED) & set(JAX_ONLY)
    assert all(len(r) > 30 for r in JAX_ONLY.values())


@pytest.mark.parametrize("jax_name", sorted(RENAMED))
def test_renamed_counterpart_exists(jax_name):
    path, name = RENAMED[jax_name].split("::")
    path = ROOT / path
    assert path.exists(), path
    if path.suffix == ".py":
        defs = _defs(path)
        cls, _, method = name.rpartition(".")
        if cls:
            assert method in _methods(_port_classes(), cls), name
        else:
            assert name in defs, name
    else:
        assert re.search(rf"\b{re.escape(name)}\s*[(<]", path.read_text()), \
            name


def test_port_modules_exist_for_every_jax_module():
    """Every JAX module has its port module (same path, or MODULES)."""
    for path in JAX.rglob("*.py"):
        rel = path.relative_to(JAX).as_posix()
        assert (PORT / MODULES.get(rel, rel)).exists(), rel


# ---------------------------------------------------------------------------
# the repo's entry points: examples/*.py, tools/*.py and the root bench*.py
# ---------------------------------------------------------------------------

ENTRY_POINTS = sorted(
    [p.relative_to(ROOT).as_posix() for p in (ROOT / "examples").glob("*.py")]
    + [p.relative_to(ROOT).as_posix() for p in (ROOT / "tools").glob("*.py")]
    + [p.name for p in ROOT.glob("bench*.py")])

# tools/*.py files that are the port's own (they drive `similari_tpu_torch`
# or chip_smoke.py on the card and import no JAX): no counterpart needed
PORT_TOOLS = {
    "tools/profile_dots_clip.py",
    "tools/profile_fused_sort.py",
    "tools/profile_fused_visual.py",
    "tools/profile_torch_sort.py",
}

# JAX entry point -> the ROADMAP item that will port it (none: every entry
# point has its counterpart)
PENDING = {}


def _entry_counterpart(path: str) -> Path:
    """examples/x.py -> similari_tpu_torch/examples/x.py, tools/x.py ->
    similari_tpu_torch/tools/x.py, bench*.py -> similari_tpu_torch/."""
    return PORT / path


def _imports(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_entry_point_is_ported_or_pending(path):
    port = _entry_counterpart(path)
    if path in PORT_TOOLS:
        bad = [n for n in _imports(ROOT / path)
               if n.split(".")[0] in ("jax", "jaxlib", "similari_tpu")]
        assert not bad, f"{path} imports {bad}: not a port tool"
        return
    if path in PENDING:
        assert not port.exists(), (
            f"{path} is ported to {port}: take it out of PENDING")
        return
    assert port.exists(), (f"{path} has no counterpart {port} and no entry "
                           "in PENDING")
    assert "main" in _defs(port), f"{port} has no main()"


def test_entry_point_tables_name_entry_points():
    assert len(ENTRY_POINTS) == 22 + 12 + 3
    assert set(PENDING) <= set(ENTRY_POINTS)
    assert set(PORT_TOOLS) <= set(ENTRY_POINTS)
    assert not set(PENDING) & set(PORT_TOOLS)
