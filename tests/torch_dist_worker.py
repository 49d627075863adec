"""Rank processes for the port's sharded tests.

`spawn(world, cases, tmp)` starts `world` processes (the `spawn` start
method) that join one gloo process group through a file in `tmp`, run
each case's scenario on their block of the scenes and write their results
to `tmp/rank<r>.npz`; it returns every rank's results.  Inputs and results
cross as npz files of numpy arrays, never through queues.

A spawned child imports this module to find its target, so it imports
neither JAX nor tests/conftest.py: only numpy, torch, the port and
tests/torch_parity.py.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import sys
import traceback
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from similari_tpu_torch.convert import (sort_state_from_numpy,
                                        sort_state_to_numpy,
                                        visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.parallel import (dryrun_multichip,
                                         global_gallery_query,
                                         local_gallery_query, pod_mesh,
                                         scene_mesh, shard_batched_state,
                                         sharded_sort_scan, sharded_sort_step,
                                         sharded_visual_scan,
                                         sharded_visual_step, track_merge,
                                         track_migration)
from similari_tpu_torch.trackers.sort_step import SortConfig
from similari_tpu_torch.trackers.visual_step import VisualConfig

from torch_parity import VISUAL_CONFIGS, one_cpu_thread

CPU = torch.device("cpu")
SORT_CONFIGS = {
    "aligned": dict(method="iou", assignment="auction", max_idle_epochs=5,
                    oriented=False),
    "oriented": dict(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=True),
}
JOIN_SECONDS = 240


# --------------------------------------------------------------------------
# nested dicts of arrays <-> flat npz keys
# --------------------------------------------------------------------------

def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat) -> Dict:
    out: Dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return out


# --------------------------------------------------------------------------
# scenarios: (mesh, inputs) -> results, on this rank's block
# --------------------------------------------------------------------------

def _mesh(inp):
    hosts = int(inp["pod_hosts"])
    world = dist.get_world_size()
    if hosts:
        return pod_mesh(hosts, world // hosts, device="cpu")
    return scene_mesh(world, device="cpu")


def _tensors(inp, keys):
    return [torch.as_tensor(np.ascontiguousarray(inp[k])) for k in keys]


def _block(mesh, a, axis):
    """This rank's block of a global array's scene axis."""
    n = a.shape[axis] // mesh.size
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(mesh.shard * n, (mesh.shard + 1) * n)
    return torch.as_tensor(np.ascontiguousarray(a[tuple(idx)]))


def _visual_start(inp, mesh):
    state = visual_state_from_numpy(
        inp["state"], CPU, feature_dtype=torch.bfloat16
        if bool(inp.get("bf16", False)) else None)
    return shard_batched_state(state, mesh)


SORT_STREAMS = ("box", "conf", "valid")
VISUAL_STREAMS = ("box", "conf", "valid", "feat", "fvalid", "qual", "oa")


def run_sort_scan(inp):
    mesh = _mesh(inp)
    cfg = SortConfig(**SORT_CONFIGS[str(inp["config"])])
    state = shard_batched_state(sort_state_from_numpy(inp["state"], CPU),
                                mesh)
    state, ids, new, ovf = sharded_sort_scan(cfg, mesh)(
        state, *(_block(mesh, inp[k], 1) for k in SORT_STREAMS),
        _block(mesh, inp["epochs0"], 0))
    return {"ids": ids, "total_new": new, "total_overflow": ovf,
            "state": sort_state_to_numpy(state)}


def run_visual_scan(inp):
    mesh = _mesh(inp)
    cfg = VisualConfig(**VISUAL_CONFIGS[str(inp["config"])])
    state, ids, new, ovf = sharded_visual_scan(cfg, mesh)(
        _visual_start(inp, mesh),
        *(_block(mesh, inp[k], 1) for k in VISUAL_STREAMS),
        _block(mesh, inp["epochs0"], 0))
    return {"ids": ids, "total_new": new, "total_overflow": ovf,
            "state": visual_state_to_numpy(state)}


def _steps(inp, step, state, streams):
    """Each frame of the streams through a sharded step, at epochs0 + i."""
    mesh = _mesh(inp)
    out = {}
    for i in range(inp[streams[0]].shape[0]):
        state, o, new = step(
            state, *(_block(mesh, inp[k][i], 0) for k in streams),
            _block(mesh, inp["epochs0"], 0) + i)
        out[f"frame{i}"] = {
            f.name: getattr(o, f.name) for f in dataclasses.fields(o)}
        out[f"frame{i}"]["new_tracks"] = new
    return state, out


def run_sort_step(inp):
    mesh = _mesh(inp)
    cfg = SortConfig(**SORT_CONFIGS[str(inp["config"])])
    state = shard_batched_state(sort_state_from_numpy(inp["state"], CPU),
                                mesh)
    state, out = _steps(inp, sharded_sort_step(cfg, mesh), state,
                        SORT_STREAMS)
    out["state"] = sort_state_to_numpy(state)
    return out


def run_visual_step(inp):
    mesh = _mesh(inp)
    cfg = VisualConfig(**VISUAL_CONFIGS[str(inp["config"])])
    state, out = _steps(inp, sharded_visual_step(cfg, mesh),
                        _visual_start(inp, mesh), VISUAL_STREAMS)
    out["state"] = visual_state_to_numpy(state)
    return out


def run_gallery(inp):
    mesh = _mesh(inp)
    kind, k = str(inp["kind"]), int(inp["k"])
    state = _visual_start(inp, mesh)
    queries = torch.as_tensor(inp["queries"])
    local = local_gallery_query(kind, k, mesh)(state, queries)
    glob = global_gallery_query(kind, k, mesh)(state, queries)
    return {"local": dict(zip(("scores", "scene", "track"), local)),
            "global": dict(zip(("scores", "shard", "scene", "track"),
                               glob))}


def _handoff(inp, op, visual):
    """The calls `call<i>/...` in turn on this rank's block."""
    mesh = _mesh(inp)
    if visual:
        state, to_numpy = _visual_start(inp, mesh), visual_state_to_numpy
    else:
        state = shard_batched_state(
            sort_state_from_numpy(inp["state"], CPU), mesh)
        to_numpy = sort_state_to_numpy
    fn = op(mesh)
    out = {}
    for i in range(int(inp["calls"])):
        args = _tensors(inp[f"call{i}"], ("a", "b", "c", "d"))
        state, *res = fn(state, *args)
        out[f"call{i}"] = dict(zip(("success", "new_ids"), res))
        out[f"call{i}"]["state"] = to_numpy(state)
    return out


def run_migration(inp):
    return _handoff(inp, track_migration, bool(inp["visual"]))


def run_merge(inp):
    return _handoff(inp, track_merge, True)


def run_dryrun(inp):
    dryrun_multichip(dist.get_world_size(), device="cpu")
    return {"ok": np.array(True)}


def raise_on_rank_one(mesh, _spec):
    """A rank target of `similari_tpu_torch/bench_pod.py::run_ranks` whose
    rank 1 raises."""
    if mesh.shard == 1:
        raise ValueError(f"rank 1 of {mesh.size} raised")
    return {}


SCENARIOS = {f.__name__[4:]: f for f in (
    run_sort_scan, run_visual_scan, run_sort_step, run_visual_step,
    run_gallery, run_migration, run_merge, run_dryrun)}


# --------------------------------------------------------------------------
# the rank processes
# --------------------------------------------------------------------------

def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tree)


def _rank_main(rank: int, world: int, tmp: str, cases: Dict[str, str]):
    one_cpu_thread()
    tmp = Path(tmp)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp / 'pg'}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        with np.load(tmp / "inputs.npz") as data:
            inputs = unflatten({k: data[k] for k in data.files})
        out = {case: _numpy(SCENARIOS[scenario](inputs[case]))
               for case, scenario in cases.items()}
        np.savez(tmp / f"rank{rank}.npz", **flatten(out))
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, cases: Dict[str, str], inputs: Dict,
          tmp: Path) -> list:
    """Run `cases` (case name -> scenario name; `inputs[case]` its input
    arrays) in `world` gloo ranks; returns each rank's results, a nested
    dict per case."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **flatten(inputs))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp), cases))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_SECONDS)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"rank processes failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           + "\n".join(errors))
    results = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as data:
            results.append(unflatten({k: data[k] for k in data.files}))
    return results
