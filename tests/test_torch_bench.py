"""The port's benchmark entry point (`similari_tpu_torch/bench.py`) against
the JAX package's `bench.py`.

bench.py's workloads are built here but never timed: its `per_step_time`
is replaced by one that keeps the workload's `run` closure, whose free
variables are bench.py's own device inputs and compiled scans.  The port's
workload builders must hold the same inputs bit for bit, count the same
FLOPs, and give the same ids as those scans (the Pallas ones in interpret
mode) at tiny widths.  Then the port's `main()` on a tiny table: one
parseable JSON line, `<name>_error` and exit code 1 for a configuration
that raises, and no line at all without CUDA.
"""

import ast
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench as jbench  # noqa: E402  (the JAX package's bench.py)
from similari_tpu.ops.pallas_sort import compiled_pallas_sort_scan  # noqa: E402
from similari_tpu.ops.pallas_visual import compiled_pallas_visual_scan  # noqa: E402
from similari_tpu.parallel import new_batched_visual_state as jax_batched_visual_state  # noqa: E402
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig  # noqa: E402
from similari_tpu.trackers.state import new_sort_state as jax_new_sort_state  # noqa: E402
from similari_tpu.trackers.visual_state import new_visual_state as jax_new_visual_state  # noqa: E402
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig  # noqa: E402
from similari_tpu_torch import bench as pb  # noqa: E402

from torch_parity import one_cpu_thread  # noqa: E402

one_cpu_thread()

CPU = "cpu"
N, F, L, CHUNK, SCENES = 8, 16, 8, 4, 3


def bench_closure(monkeypatch, fn, *args, **kwargs):
    """Build bench.py's workload `fn(*args, **kwargs)` without timing it.
    Returns (its FLOPs per frame, the free variables of its `run` and of
    the functions `run` reaches, by name)."""
    kept = {}

    def keep(run, base_len, **_):
        kept["run"] = run
        return 1.0

    monkeypatch.setattr(jbench, "per_step_time", keep)
    _, flops = fn(*args, **kwargs)
    free = {}

    def collect(f, depth):
        f = getattr(f, "__wrapped__", f)
        if depth > 2 or not inspect.isfunction(f):
            return
        for name, v in inspect.getclosurevars(f).nonlocals.items():
            free.setdefault(name, v)
            if callable(v):
                collect(v, depth + 1)

    collect(kept["run"], 0)
    return flops, free


def same_inputs(w, free):
    """Every input of the port's workload equals bench.py's of that name."""
    for name, x in w.inputs.items():
        got = x.numpy() if isinstance(x, torch.Tensor) else x
        np.testing.assert_array_equal(got, np.asarray(free[name]),
                                      err_msg=name)


# --------------------------------------------------------------------------
# bench.py's streams and FLOP counts at every configuration's arguments
# --------------------------------------------------------------------------

def _stream_args(c):
    """bench.py's box_stream call of configuration `c` (steps, n, seed,
    spread), or None where it makes no box_stream (the host NMS)."""
    if c.build in (pb.batch_visual_workload, pb.batch_sort_workload):
        return (c.base_len, c.args[0] * c.args[1], 42, 1000.0)
    if c.build is pb.sort_scan_workload:
        return (c.base_len, c.args[1], 42, 1000.0)
    if c.build in (pb.sort_pallas_workload, pb.visual_pallas_workload,
                   pb.visual_scan_workload):
        return (c.base_len, c.args[0], 42, 1000.0)
    if c.build is pb.nms_workload:
        return (c.base_len, c.args[0], 5, 500.0)
    assert c.build is pb.nms_host_workload
    return None


def _flops_pair(c):
    """(the port's, bench.py's) FLOPs per frame of configuration `c`."""
    b, a = c.build, c.args
    if b is pb.batch_visual_workload:
        args = (a[1], 2 * a[1], 3, a[2])
        return pb.visual_step_flops(*args), jbench.visual_step_flops(*args)
    if b in (pb.visual_pallas_workload, pb.visual_scan_workload):
        args = (a[0], 4 * a[0], 3, a[1])
        return pb.visual_step_flops(*args), jbench.visual_step_flops(*args)
    if b is pb.batch_sort_workload:
        args = (a[1], 2 * a[1], "iou", False)
    elif b is pb.sort_scan_workload:
        args = (a[1], 4 * a[1], a[0], a[2])
    elif b is pb.sort_pallas_workload:
        args = (a[0], 4 * a[0], "iou", False)
    else:
        return pb.nms_step_flops(*a[:2]), jbench.nms_step_flops(*a[:2])
    return pb.sort_step_flops(*args), jbench.sort_step_flops(*args)


WORKLOAD_CONFIGS = [c for c in pb.CONFIGS if isinstance(c, pb.Config)]


def bench_py_matrix():
    """{name: (frames, args)} of every configuration bench.py's main()
    runs, from the lists in its source (the first, full assignment of
    each; the BENCH_FAST subsets come later)."""
    lists = {}
    for node in ast.walk(ast.parse(inspect.getsource(jbench.main))):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                          ast.Name)
                and node.targets[0].id.endswith(("_sweep", "_configs",
                                                 "_cfgs"))
                and node.targets[0].id not in lists):
            lists[node.targets[0].id] = ast.literal_eval(node.value)
    host_frames = inspect.signature(
        jbench.bench_nms_host).parameters["frames"].default
    out = {f"batch_visual_{s}x100x512": (n, (s, 100, 512))
           for s, n in lists["visual_sweep"]}
    out.update({f"batch_sort_{s}x100": (n, (s, 100))
                for s, n in lists["sort_sweep"]})
    out.update({name: (n, (m, d, o))
                for name, m, d, o, n in lists["sort_configs"]})
    # the fused-kernel calls (bench.py:768, :779, :785)
    out.update({"sort_iou_100_pallas": (2048, (100,)),
                "visual_sort_100x512_pallas": (256, (100, 512)),
                "visual_sort_100x512_pallas_maha": (256, (100, 512))})
    out.update({f"visual_sort_{d}x{f}": (n, (d, f))
                for d, f, n in lists["visual_cfgs"]})
    # bench_nms_host takes its own frame count, not the table's
    out.update({name: (host_frames if d <= 10 else n, (d, o))
                for name, d, o, n in lists["nms_configs"]})
    return out


def test_matrix_is_bench_py_matrix():
    """Every configuration bench.py's main() runs, by name, with its
    arguments and frame count, then the interactive rows."""
    port = {c.name: (c.base_len, c.args) for c in WORKLOAD_CONFIGS}
    assert port == bench_py_matrix()
    assert [c.name for c in pb.CONFIGS if isinstance(c, pb.RowsConfig)] == [
        "interactive_host"]
    maha = [c for c in WORKLOAD_CONFIGS if c.name.endswith("pallas_maha")]
    assert maha[0].kwargs == dict(positional="maha")
    assert [c.name for c in WORKLOAD_CONFIGS if c.fast] == [
        "batch_visual_64x100x512", "batch_sort_64x100", "sort_iou_100"]
    assert [c.name for c in WORKLOAD_CONFIGS if c.sweep] == [
        f"batch_visual_{s}x100x512" for s in (64, 256, 1024)]


@pytest.mark.parametrize("c", WORKLOAD_CONFIGS, ids=lambda c: c.name)
def test_box_stream_and_flops_equal_bench_py(c):
    args = _stream_args(c)
    if args is not None:
        steps, n, seed, spread = args
        np.testing.assert_array_equal(
            pb.box_stream(steps, n, seed=seed, spread=spread),
            jbench.box_stream(steps, n, seed=seed, spread=spread))
    port, jax_ = _flops_pair(c)
    assert port == jax_


def test_baselines_equal_bench_py():
    assert pb.BASELINES == jbench.BASELINES


# --------------------------------------------------------------------------
# the workload builders against bench.py's, at tiny widths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method,oriented", [("iou", False), ("iou", True),
                                             ("maha", True)])
def test_sort_scan_workload_matches_bench_py(monkeypatch, method, oriented):
    flops, free = bench_closure(monkeypatch, jbench.bench_sort_scan, method,
                                N, oriented, L)
    w = pb.sort_scan_workload(method, N, oriented, L, device=CPU)
    assert w.flops == flops
    same_inputs(w, free)
    if method == "maha":  # inputs only: the ids are the aligned rows' step
        return
    _, out = free["scan"](jax_new_sort_state(4 * N, 1), free["stream"],
                          free["conf"], free["valid"], jnp.int32(1))
    np.testing.assert_array_equal(w.run(L)[0].numpy(),
                                  np.asarray(out.track_id))


def test_sort_pallas_workload_matches_bench_py(monkeypatch):
    flops, free = bench_closure(monkeypatch, jbench.bench_sort_pallas, N, L,
                                chunk=CHUNK)
    w = pb.sort_pallas_workload(N, L, device=CPU, chunk=CHUNK)
    assert w.flops == flops and w.granule == CHUNK
    same_inputs(w, free)
    scan = compiled_pallas_sort_scan(
        JaxSortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                      oriented=False), CHUNK, interpret=True)
    _, (ids, _, _, _) = scan(jax_new_sort_state(4 * N, 1), free["stream"],
                             free["conf"], free["valid"], jnp.int32(1))
    np.testing.assert_array_equal(w.run(L)[0].numpy(), np.asarray(ids))


@pytest.mark.parametrize("positional", ["iou", "maha"])
def test_visual_pallas_workload_matches_bench_py(monkeypatch, positional):
    flops, free = bench_closure(monkeypatch, jbench.bench_visual_pallas, N,
                                F, L, chunk=CHUNK, positional=positional)
    w = pb.visual_pallas_workload(N, F, L, device=CPU, chunk=CHUNK,
                                  positional=positional)
    assert w.flops == flops
    same_inputs(w, free)
    if positional == "maha":  # inputs only: tests/test_torch_fused_visual.py
        return                # holds the Mahalanobis kernel to JAX's
    cfg = JaxVisualConfig(
        positional_kind=positional, visual_kind="euclidean",
        visual_threshold=100.0, visual_minimal_track_length=3,
        max_idle_epochs=5, assignment="auction", oriented=False,
        feature_precision="bf16")
    onesv, truv = free["onesv"], free["truv"]
    _, (ids, *_) = compiled_pallas_visual_scan(cfg, CHUNK, interpret=True)(
        jax_new_visual_state(4 * N, 1, 3, F), free["stream"], onesv, truv,
        free["feats"], truv, onesv, onesv, jnp.int32(1))
    np.testing.assert_array_equal(w.run(L)[0].numpy(), np.asarray(ids))


def test_batch_visual_workload_matches_bench_py(monkeypatch):
    """The in-place batched VisualSORT (S=3) against bench.py's scan of the
    JAX package's batched_visual_step_chunked."""
    flops, free = bench_closure(monkeypatch, jbench.bench_batch_visual_scan,
                                SCENES, N, F, L)
    w = pb.batch_visual_workload(SCENES, N, F, L, device=CPU)
    assert w.flops == flops and w.scenes == SCENES
    same_inputs(w, free)
    states = jax_batched_visual_state(SCENES, 2 * N, 1, 3, F,
                                      feature_dtype=jnp.bfloat16)
    _, ids = free["scan_fn"](states, free["boxes"],
                             jnp.full((SCENES,), 1, jnp.int32))
    got = w.run(L)[0].numpy()
    assert got.shape == (L, SCENES, N)
    np.testing.assert_array_equal(got, np.asarray(ids))


@pytest.mark.parametrize("kind", ["batch_sort", "visual_scan", "nms",
                                  "nms_oriented"])
def test_workload_inputs_equal_bench_py(monkeypatch, kind):
    """The builders whose ids the step's own parity tests cover: inputs and
    FLOPs equal bench.py's, and a run gives outputs of the stream's shape."""
    if kind == "batch_sort":
        flops, free = bench_closure(monkeypatch, jbench.bench_batch_sort_scan,
                                    SCENES, N, L)
        w = pb.batch_sort_workload(SCENES, N, L, device=CPU)
        shape = (L, SCENES, N)
    elif kind == "visual_scan":
        flops, free = bench_closure(monkeypatch, jbench.bench_visual_scan, N,
                                    F, L)
        w = pb.visual_scan_workload(N, F, L, device=CPU)
        shape = (L, N)
    else:
        oriented = kind == "nms_oriented"
        flops, free = bench_closure(monkeypatch, jbench.bench_nms, N,
                                    oriented, L)
        w = pb.nms_workload(N, oriented, L, device=CPU)
        shape = (L, N)
    assert w.flops == flops
    same_inputs(w, free)
    assert w.run(L)[0].shape == shape


def test_nms_workload_keeps_bench_py_count(monkeypatch):
    """bench.py's NMS scan sums the kept boxes of every frame."""
    _, free = bench_closure(monkeypatch, jbench.bench_nms, N, True, L)
    w = pb.nms_workload(N, True, L, device=CPU)
    want = int(free["scan_nms"](jnp.int32(0), free["boxes"], free["ranks"]))
    assert int(w.run(L)[0].sum()) == want


# --------------------------------------------------------------------------
# main() on a tiny table
# --------------------------------------------------------------------------

TINY = [
    pb.Config("batch_visual_3x8x16", pb.batch_visual_workload,
              (SCENES, N, F), 4, unit=pb.SCENES, sweep=True),
    pb.Config("batch_sort_3x8", pb.batch_sort_workload, (SCENES, N), 4,
              unit=pb.SCENES),
    pb.Config("sort_iou_oriented_8", pb.sort_scan_workload,
              ("iou", N, True), 6),
    pb.Config("sort_iou_8_pallas", pb.sort_pallas_workload, (N,), 8,
              kwargs=dict(chunk=CHUNK)),
    pb.Config("visual_sort_8x16_pallas", pb.visual_pallas_workload, (N, F),
              8, kwargs=dict(chunk=CHUNK)),
    pb.Config("visual_sort_8x16", pb.visual_scan_workload, (N, F), 4),
    pb.Config("nms_10", pb.nms_host_workload, (10, False), 64,
              unit="frames/s"),
    pb.Config("nms_oriented_8", pb.nms_workload, (N, True), 4,
              unit="frames/s"),
]


def _last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_main_prints_one_line_with_the_keys(monkeypatch, capsys):
    monkeypatch.setattr(pb, "CONFIGS", TINY)
    assert pb.main(["--device", "cpu"]) == 0
    line = _last_line(capsys)
    assert line["metric"] == "batch_visual_sort_scene_fps"
    assert line["device"] == "cpu"
    extra = line["extra"]
    assert line["value"] == extra["batch_visual_3x8x16_fps"] > 0
    assert extra["knee_scenes"] == SCENES
    assert not [k for k in extra if k.endswith("_error")]
    for c in TINY:
        assert extra[c.name + "_fps"] > 0
        lo, hi = extra[c.name + "_spread"]
        assert lo <= extra[c.name + "_fps"] <= hi
    assert set(k for k in extra if k.startswith("mfu_")) == {
        "mfu_batch_visual_3x8x16", "mfu_visual_sort_8x16_pallas",
        "mfu_visual_sort_8x16"}
    # significant figures, not decimals: these tiny rows' MFU shows
    assert all(v > 0 for k, v in extra.items() if k.startswith("mfu_"))
    # idle shares and peak memory are device metrics: none on the CPU
    assert not [k for k in extra if k.endswith(("_idle", "_peak_mib"))]


def test_fast_subset_runs_only_fast_rows(monkeypatch, capsys):
    table = [dataclasses.replace(TINY[0], fast=True), *TINY[1:3]]
    monkeypatch.setattr(pb, "CONFIGS", table)
    monkeypatch.setenv("BENCH_FAST", "1")
    assert pb.main(["--device", "cpu"]) == 0
    extra = _last_line(capsys)["extra"]
    assert [k for k in extra if k.endswith("_fps")] == [
        "batch_visual_3x8x16_fps"]
    assert "batch_visual_3x8x16_spread" not in extra  # one run per row


def test_a_failing_config_records_its_error_and_exits_1(monkeypatch,
                                                        capsys):
    def broken(*args, **kwargs):
        raise ValueError("no such workload")

    table = [TINY[1], pb.Config("broken_8", broken, (N,), 4)]
    monkeypatch.setattr(pb, "CONFIGS", table)
    assert pb.main(["--device", "cpu"]) == 1
    line = _last_line(capsys)
    assert "no such workload" in line["extra"]["broken_8_error"]
    assert line["extra"]["batch_sort_3x8_fps"] > 0
    assert line["value"] is None and line["extra"]["knee_scenes"] is None


def test_budget_skips_with_a_log_line(monkeypatch, capsys):
    monkeypatch.setattr(pb, "CONFIGS", TINY[1:3])
    monkeypatch.setenv("BENCH_BUDGET", "0")
    assert pb.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "SKIPPED (time budget 0s exceeded): batch_sort_3x8" in captured.err
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert not [k for k in line["extra"] if k.endswith("_fps")]


@pytest.mark.parametrize("module", ["bench", "bench_interactive"])
def test_no_cuda_raises_and_prints_no_line(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from similari_tpu_torch import bench_interactive as pbi

    main = pb.main if module == "bench" else pbi.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
    assert capsys.readouterr().out == ""


class _Event:
    def __init__(self, name, us, device_type=torch.autograd.DeviceType.CUDA):
        self.name = name
        self.device_type = device_type
        self.time_range = type("R", (), {"elapsed_us": lambda _, u=us: u})()


@pytest.mark.parametrize("seen,want", [(2, 0.3), (1, None), (0, None),
                                       (3, None)])
def test_device_busy_needs_every_counted_launch(monkeypatch, seen, want):
    """The idle share's busy time: None when the profile's kernels on the
    device do not match its launch calls on the host (a profile on the
    card can miss kernels), else the device events' summed time."""
    cpu = torch.autograd.DeviceType.CPU
    events = ([_Event("Memcpy HtoD (Pageable -> Device)", 100)]
              + [_Event("cudaLaunchKernel", 5, cpu),
                 _Event("cudaLaunchKernelExC", 5, cpu),
                 _Event("cudaMemcpyAsync", 5, cpu),
                 _Event("aten::add", 5, cpu)]
              + [_Event("(anonymous namespace)::fused_sort_kernel", 100)]
              * seen)

    class Profile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    w = pb.Workload(lambda: None, lambda state, n: None, 1.0, {})
    got = pb.device_busy_ms(w, 4)
    assert got == pytest.approx(want) if want else got is None


@pytest.mark.parametrize("rc,stdout,want", [
    (0, '{"idle": 0.25}\n', 0.25), (0, '{"idle": null}\n', None),
    (1, "", RuntimeError)])
def test_idle_share_from_its_own_process(monkeypatch, capsys, rc, stdout,
                                         want):
    """Each row's profile is its own process's only one: `--profile NAME`
    of this module; its detail lines are passed on, its failure raises."""
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(
            cmd, rc, stdout, "  idle share not measured: detail\nnoise\n")

    monkeypatch.setattr(pb.subprocess, "run", run)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="sort_iou_100 exited 1"):
            pb.idle_share("sort_iou_100")
    else:
        assert pb.idle_share("sort_iou_100") == want
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "similari_tpu_torch.bench", "--profile",
                       "sort_iou_100"]
    assert (Path(kw["cwd"]) / "similari_tpu_torch" / "bench.py").is_file()
    err = capsys.readouterr().err
    assert "idle share not measured: detail" in err and "noise" not in err


def test_profile_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.main(["--profile", "sort_iou_100"])
