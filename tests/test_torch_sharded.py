"""The port's sharded scans and steps (`parallel/mesh.py`) against the JAX
package's, across processes.

JAX runs `sharded_sort_scan`, `sharded_visual_scan`, `sharded_sort_step`
and `sharded_visual_step` on 2- and 4-device scene meshes and a 2x2 pod
mesh of forced host devices.  The port runs the same global inputs in
gloo process groups of 2 and 4 spawned ranks (tests/torch_dist_worker.py,
one spawn per world size for every case of this file), each rank on its
block of scenes; the blocks are joined here.

Ids, is_new, overflow flags and the reduced counts must be equal; states
are held at tests/torch_parity.py's tolerances.  One scene of each batch
overflows its slots beside quiet ones, and every scene must equal its own
single-scene run of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from similari_tpu.parallel import mesh as jmesh
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.convert import (sort_state_from_numpy,
                                        visual_state_from_numpy)
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig, sort_scan
from similari_tpu_torch.trackers.visual_step import VisualConfig, visual_scan

from torch_dist_worker import SORT_CONFIGS, spawn
from torch_parity import (VISUAL_CONFIGS, assert_state_dicts_match,
                          jax_state_dict, one_cpu_thread, oriented_stream,
                          sort_overflow_stream, sort_stream,
                          visual_overflow_stream, visual_stream)

one_cpu_thread()

CPU = torch.device("cpu")
S, N, D, T, H, K, F = 8, 6, 8, 16, 2, 3, 8
SORT_OVERFLOW, VISUAL_OVERFLOW = 3, 5  # the scene that runs out of slots
EPOCHS0 = np.array([1, 5, 2, 1, 3, 1, 1, 2], np.int32)
VCFG = "euclid_iou"

# case -> (scenario, config, world, pod hosts)
CASES = {
    "sort_scan_2": ("sort_scan", "aligned", 2, 0),
    "sort_scan_4": ("sort_scan", "aligned", 4, 0),
    "sort_scan_pod": ("sort_scan", "oriented", 4, 2),
    "visual_scan_2": ("visual_scan", VCFG, 2, 0),
    "visual_scan_4": ("visual_scan", VCFG, 4, 0),
    "sort_step_2": ("sort_step", "aligned", 2, 0),
    "visual_step_4": ("visual_step", VCFG, 4, 0),
}
SCANS = [c for c in CASES if "scan" in c]
STEPS = [c for c in CASES if "step" in c]


def _sort_streams(oriented):
    """[N, S, ...] box, conf, valid: random walks, one overflowing scene."""
    scenes = []
    for s in range(S):
        if s == SORT_OVERFLOW:
            box, valid = sort_overflow_stream(N, D, seed=s)
            scenes.append((box, np.ones(valid.shape, np.float32), valid))
        elif oriented:
            scenes.append(oriented_stream(s, N, D))
        else:
            box, valid = sort_stream(s, N, D)
            scenes.append((box, np.ones(valid.shape, np.float32), valid))
    return [np.stack(x, axis=1) for x in zip(*scenes)]


def _visual_streams():
    scenes = [visual_overflow_stream(N, D, F) if s == VISUAL_OVERFLOW
              else visual_stream(s, N, D, F) for s in range(S)]
    return [np.stack(x, axis=1) for x in zip(*scenes)]


def _inputs(case):
    scenario, config, _, hosts = CASES[case]
    visual = "visual" in scenario
    streams = (_visual_streams() if visual
               else _sort_streams(config == "oriented"))
    keys = ("box", "conf", "valid", "feat", "fvalid", "qual", "oa")
    state = (jmesh.new_batched_visual_state(S, T, H, K, F) if visual
             else jmesh.new_batched_state(S, T, H))
    inp = dict(zip(keys, streams))
    inp.update(state=jax_state_dict(state), epochs0=EPOCHS0,
               config=np.array(config), pod_hosts=np.array(hosts))
    if "step" in scenario:  # two frames, as tests/test_parallel.py steps
        inp.update({k: v[:2] for k, v in zip(keys, streams)})
    return inp


def _jax_mesh(case):
    _, _, world, hosts = CASES[case]
    if hosts:
        return jmesh.pod_mesh(hosts, world // hosts)
    return jmesh.scene_mesh(world)


def _jax_run(case, inp):
    scenario, config, _, _ = CASES[case]
    mesh = _jax_mesh(case)
    visual = "visual" in scenario
    cfg = (JaxVisualConfig(**VISUAL_CONFIGS[config]) if visual
           else JaxSortConfig(**SORT_CONFIGS[config]))
    start = (jmesh.new_batched_visual_state(S, T, H, K, F) if visual
             else jmesh.new_batched_state(S, T, H))
    sharding = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    state = jax.tree.map(lambda a: jax.device_put(a, sharding), start)
    keys = (("box", "conf", "valid", "feat", "fvalid", "qual", "oa")
            if visual else ("box", "conf", "valid"))
    streams = [jnp.asarray(inp[k]) for k in keys]
    ep0 = jnp.asarray(inp["epochs0"])
    if "scan" in scenario:
        build = jmesh.sharded_visual_scan if visual else (
            jmesh.pod_sharded_sort_scan if CASES[case][3]
            else jmesh.sharded_sort_scan)
        state, ids, new, ovf = build(cfg, mesh)(state, *streams, ep0)
        return {"ids": np.asarray(ids), "total_new": int(new),
                "total_overflow": int(ovf), "state": jax_state_dict(state)}
    step = (jmesh.sharded_visual_step if visual
            else jmesh.sharded_sort_step)(cfg, mesh)
    out = {}
    for i in range(streams[0].shape[0]):
        state, o, new = step(state, *(x[i] for x in streams), ep0 + i)
        out[f"frame{i}"] = {"track_id": np.asarray(o.track_id),
                            "is_new": np.asarray(o.is_new),
                            "overflow": np.asarray(o.overflow),
                            "new_tracks": int(new)}
        if visual:
            out[f"frame{i}"]["voting_type"] = np.asarray(o.voting_type)
    out["state"] = jax_state_dict(state)
    return out


def _join(blocks, axis):
    """Join the ranks' blocks of one result along the scene axis; a
    reduced count (0-d) is every rank's, and rank 0's is kept."""
    if isinstance(blocks[0], dict):
        return {k: _join([b[k] for b in blocks], axis) for k in blocks[0]}
    if np.ndim(blocks[0]) == 0:
        return np.asarray(blocks[0])
    return np.concatenate([np.asarray(b) for b in blocks], axis=axis)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case -> (inputs, the port's joined results, every rank's results)."""
    inputs = {case: _inputs(case) for case in CASES}
    out = {}
    for world in (2, 4):
        cases = {c: CASES[c][0] for c in CASES if CASES[c][2] == world}
        ranks = spawn(world, cases, {c: inputs[c] for c in cases},
                      tmp_path_factory.mktemp(f"world{world}"))
        for c in cases:
            per_rank = [r[c] for r in ranks]
            joined = {k: _join([r[k] for r in per_rank],
                               1 if k == "ids" else 0)
                      for k in per_rank[0] if k not in (
                          "total_new", "total_overflow")}
            out[c] = (inputs[c], joined, per_rank)
    return out


def _same_counts(per_rank, key):
    """A reduced count: equal on every rank; returns it."""
    vals = {int(r[key]) for r in per_rank}
    assert len(vals) == 1, (key, vals)
    return vals.pop()


@pytest.mark.parametrize("case", SCANS)
def test_sharded_scan_matches_jax(runs, case):
    inp, got, per_rank = runs[case]
    want = _jax_run(case, inp)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert _same_counts(per_rank, "total_new") == want["total_new"]
    assert _same_counts(per_rank, "total_overflow") == want["total_overflow"]
    assert want["total_overflow"] > 0
    assert_state_dicts_match(want["state"], got["state"])


@pytest.mark.parametrize("case", SCANS)
def test_sharded_scan_scenes_match_single_scene_runs(runs, case):
    """Each scene equals its own unsharded, unbatched run of the port; the
    reduced counts equal the single runs' sums."""
    inp, got, per_rank = runs[case]
    scenario, config, _, _ = CASES[case]
    new = ovf = 0
    for s in range(S):
        ep = int(inp["epochs0"][s])
        if "visual" in scenario:
            one = visual_state_from_numpy(
                {k: v[s] if k != "kf" else {n: a[s] for n, a in v.items()}
                 for k, v in inp["state"].items()}, CPU)
            keys = ("box", "conf", "valid", "feat", "fvalid", "qual", "oa")
            _, out = visual_scan(VisualConfig(**VISUAL_CONFIGS[config]), one,
                                 *(torch.tensor(inp[k][:, s]) for k in keys),
                                 ep)
        else:
            one = sort_state_from_numpy(
                {k: v[s] if k != "kf" else {n: a[s] for n, a in v.items()}
                 for k, v in inp["state"].items()}, CPU)
            _, out = sort_scan(SortConfig(**SORT_CONFIGS[config]), one,
                               *(torch.tensor(inp[k][:, s])
                                 for k in ("box", "conf", "valid")), ep)
        np.testing.assert_array_equal(got["ids"][:, s], out.track_id.numpy(),
                                      err_msg=f"scene {s}")
        new += int(out.is_new.sum())
        ovf += int(out.overflow.sum())
    assert _same_counts(per_rank, "total_new") == new
    assert _same_counts(per_rank, "total_overflow") == ovf


@pytest.mark.parametrize("case", STEPS)
def test_sharded_step_matches_jax(runs, case):
    inp, got, per_rank = runs[case]
    want = _jax_run(case, inp)
    for i in range(2):
        frame = f"frame{i}"
        for k in ("track_id", "is_new", "overflow", "voting_type"):
            if k in want[frame]:
                np.testing.assert_array_equal(got[frame][k], want[frame][k],
                                              err_msg=f"{frame} {k}")
        assert {int(r[frame]["new_tracks"]) for r in per_rank} == {
            want[frame]["new_tracks"]}
    assert want["frame0"]["new_tracks"] > 0
    assert_state_dicts_match(want["state"], got["state"])


def test_visual_scan_writes_the_input_state_in_place():
    """The sharded visual forms run `batched_visual_step_inplace`: the
    gallery of the state passed in is the gallery returned, equal to the
    plain batched step's."""
    mesh = pmesh.scene_mesh(1, device="cpu")
    cfg = VisualConfig(**VISUAL_CONFIGS[VCFG])
    state = pmesh.new_batched_visual_state(2, T, H, K, F, device=CPU)
    ref = pmesh.new_batched_visual_state(2, T, H, K, F, device=CPU)
    feats = state.feats
    streams = [torch.tensor(np.stack([a, a], axis=1))
               for a in visual_stream(0, 3, D, F)]
    ep0 = torch.ones(2, dtype=torch.int32)
    out, ids, new, _ = pmesh.sharded_visual_scan(cfg, mesh)(state, *streams,
                                                            ep0)
    n_new = 0
    for i in range(3):
        ref, o = pmesh.batched_visual_step(cfg)(
            ref, *(x[i] for x in streams), ep0 + i)
        assert torch.equal(ids[i], o.track_id)
        n_new += int(o.is_new.sum())
    assert out.feats is feats and torch.equal(feats, ref.feats)
    assert int(new) == n_new


def test_mesh_rejects_what_it_cannot_run(monkeypatch):
    """A world of one rank is built when no group exists; a tensor on
    another device than the mesh's, a mesh wider than the group and a
    state that does not split raise ValueError; more shards than one
    without a group raise, naming init_process_group."""
    mesh = pmesh.scene_mesh(device="cpu")
    assert (mesh.size, mesh.shard, mesh.backend) == (1, 0, "gloo")
    assert mesh.axis_names == (pmesh.SCENE_AXIS,)
    pod = pmesh.pod_mesh(1, device="cpu")
    assert pod.shape == {pmesh.HOST_AXIS: 1, pmesh.DEVICE_AXIS: 1}
    with pytest.raises(ValueError, match="2 ranks"):
        pmesh.scene_mesh(2, device="cpu")
    state = pmesh.new_batched_state(3, T, H, device=CPU)
    step = pmesh.sharded_sort_step(SortConfig(**SORT_CONFIGS["aligned"]),
                                   mesh)
    meta = torch.empty((3, D, 5), device="meta")
    with pytest.raises(ValueError, match="on meta"):
        step(state, meta, meta[..., 0], meta[..., 0] > 0,
             torch.ones(3, dtype=torch.int32))
    monkeypatch.setattr(pmesh.Mesh, "size", property(lambda self: 2))
    with pytest.raises(ValueError, match="do not split"):
        pmesh.shard_batched_state(state, mesh)
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.scene_mesh(2, device="cpu")
