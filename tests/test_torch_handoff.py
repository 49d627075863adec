"""The port's cross-shard track migration and merge (`parallel/handoff.py`)
against the JAX package's, across processes.

Every case of tests/test_handoff.py (a move between shards, a missing
track and a full destination, two moves to one scene, the quality union
of a merge, a merge missing a row, a `VisualState` migration, the 2-D pod
mesh, conflicting merge batches), a bf16 gallery migration and one batch
that mixes moves past a full scene's free slots with moves that fit, run
by JAX on 2- and 4-device scene meshes (2x2 pod mesh) and by the port in
gloo groups of 2 and 4 spawned ranks (tests/torch_dist_worker.py).

Success flags and new ids must be equal, on every rank; the joined states
are held at tests/torch_parity.py's tolerances.  The same spawns run the
port's `dryrun_multichip`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from similari_tpu.parallel import mesh as jmesh
from similari_tpu.parallel import track_merge as jax_merge
from similari_tpu.parallel import track_migration as jax_migration
from similari_tpu_torch.convert import visual_state_from_numpy
from similari_tpu_torch.parallel import handoff as phandoff
from similari_tpu_torch.parallel import mesh as pmesh

from test_handoff import _populate_sort, _populate_visual
from torch_dist_worker import spawn
from torch_parity import assert_state_dicts_match, jax_state_dict, \
    one_cpu_thread

one_cpu_thread()


def _sort(s, t, tracks, seed):
    """A batched SortState with tracks {scene: (slots, ids)}."""
    rng = np.random.default_rng(seed)
    state = jmesh.new_batched_state(s, t, 2)
    for scene, (slots, ids) in tracks.items():
        state = _populate_sort(state, scene, slots, ids, rng)
    return state


def _visual(s, t, k, f, tracks, seed, bf16=False):
    """A batched VisualState with tracks {(scene, slot): (id, qualities,
    feature base)}."""
    rng = np.random.default_rng(seed)
    state = jmesh.new_batched_visual_state(
        s, t, 2, k, f, feature_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    for (scene, slot), (tid, quals, base) in tracks.items():
        state = _populate_visual(state, scene, slot, tid, quals, rng, base)
    return state


def _cases():
    """name -> (op, JAX state, calls [(a, b, c, d)], pod hosts, bf16)."""
    c = {}
    c["move"] = ("migration", _sort(16, 8, {1: ([2, 5], [7, 9]),
                                           11: ([0], [4])}, 0),
                 [([1], [9], [11], [42])], 0, False)
    c["missing_and_full"] = ("migration", _sort(
        8, 4, {0: ([0], [1]), 7: ([0, 1, 2, 3], [1, 2, 3, 4])}, 1),
        [([0, 0], [99, 1], [3, 7], [0, 0])], 0, False)
    c["two_to_one_scene"] = ("migration", _sort(
        8, 8, {2: ([0], [5]), 3: ([1], [6])}, 2),
        [([2, 3], [5, 6], [6, 6], [9, 9])], 0, False)
    # scene 6 has two free slots: the third and fourth found moves to it
    # fail, a missing track in between takes no rank, the rest fit
    c["full_tail_mixed"] = ("migration", _sort(
        8, 4, {0: ([0, 1, 2], [1, 2, 3]), 1: ([1, 3], [1, 2]),
               4: ([2], [5]), 6: ([0, 2], [1, 2])}, 8),
        [([0, 1, 0, 4, 0, 1, 1], [1, 9, 2, 5, 3, 1, 2],
          [6, 6, 6, 2, 6, 6, 3], [7, 7, 7, 3, 7, 7, 4])], 0, False)
    c["visual_migration"] = ("migration", _visual(
        8, 4, 2, 4, {(4, 1): (8, [0.7, 0.6], 50.0)}, 5),
        [([4], [8], [2], [1])], 0, False)
    c["visual_migration_bf16"] = ("migration", _visual(
        8, 4, 2, 4, {(4, 1): (8, [0.7, 0.6], 50.0),
                     (7, 0): (3, [0.9], 1.5)}, 5, bf16=True),
        [([4, 7], [8, 3], [2, 0], [1, 6])], 0, True)
    c["pod_migration"] = ("migration", _sort(16, 4, {0: ([1], [3])}, 6),
                          [([0], [3], [15], [4])], 2, False)
    c["merge_union"] = ("merge", _visual(
        16, 4, 3, 8, {(1, 0): (11, [0.9, 0.2], 100.0),
                      (15, 2): (22, [0.5, 0.4, 0.3], 200.0)}, 3),
        [([1], [11], [15], [22])], 0, False)
    c["merge_missing_row"] = ("merge", _visual(
        8, 4, 2, 4, {(0, 0): (1, [0.5], 10.0)}, 4),
        [([0], [1], [5], [99])], 0, False)
    c["pod_merge"] = ("merge", _visual(
        16, 4, 3, 8, {(0, 0): (11, [0.9, 0.2], 100.0),
                      (15, 2): (22, [0.5, 0.4, 0.3], 200.0)}, 9),
        [([0], [11], [15], [22])], 2, False)
    c["merge_conflicts"] = ("merge", _visual(
        8, 4, 2, 8, {(s, 0): (10 + s, [0.5], 10.0 * (s + 1))
                     for s in range(8)}, 9),
        [([0, 1], [10, 11], [2, 2], [12, 12]),  # two into one
         ([3], [13], [3], [13]),  # self-merge
         ([4, 5], [14, 15], [5, 6], [15, 16]),  # chain
         ([0, 1, 1], [10, 11, 11], [7, 2, 3], [17, 12, 13])], 0, False)
    # equal qualities across the two galleries: the top-K ties go to the
    # destination's lanes first
    c["merge_quality_ties"] = ("merge", _visual(
        8, 4, 3, 4, {(2, 1): (5, [0.25, 0.1], 1.0),
                     (6, 3): (9, [0.5, 0.25, 0.25], 7.0)}, 10),
        [([2], [5], [6], [9])], 0, False)
    return c


CASES = _cases()
RUNS = [(name, world) for name, case in CASES.items()
        for world in ((4,) if case[3] else (2, 4))]


def _jax_run(name, world):
    op, state, calls, hosts, _ = CASES[name]
    mesh = (jmesh.pod_mesh(hosts, world // hosts) if hosts
            else jmesh.scene_mesh(world))
    state = jax.tree.map(lambda a: jax.device_put(
        a, NamedSharding(mesh, P(tuple(mesh.axis_names)))), state)
    fn = (jax_migration if op == "migration" else jax_merge)(mesh)
    out = []
    for call in calls:
        state, *res = fn(state, *(jnp.asarray(x, jnp.int32) for x in call))
        out.append(([np.asarray(r) for r in res], jax_state_dict(state)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(case, world) -> every rank's results."""
    out = {}
    for world in (2, 4):
        cases, inputs = {"dryrun": "dryrun"}, {"dryrun": {
            "pod_hosts": np.array(0)}}
        for name, w in RUNS:
            if w != world:
                continue
            op, state, calls, hosts, bf16 = CASES[name]
            cases[name] = op
            inputs[name] = dict(
                state=jax_state_dict(state), calls=np.array(len(calls)),
                visual=np.array(hasattr(state, "feats")),
                bf16=np.array(bf16), pod_hosts=np.array(hosts),
                **{f"call{i}": dict(zip("abcd", (np.asarray(x, np.int32)
                                                 for x in call)))
                   for i, call in enumerate(calls)})
        res = spawn(world, cases, inputs,
                    tmp_path_factory.mktemp(f"world{world}"))
        out.update({(c, world): [r[c] for r in res] for c in cases})
    return out


@pytest.mark.parametrize("name,world", RUNS)
def test_handoff_matches_jax(ranks, name, world):
    per_rank = ranks[(name, world)]
    for i, (res, state) in enumerate(_jax_run(name, world)):
        for r, got in enumerate(per_rank):
            call = got[f"call{i}"]
            np.testing.assert_array_equal(call["success"], res[0],
                                          err_msg=f"call {i} rank {r}")
            if len(res) > 1:
                np.testing.assert_array_equal(call["new_ids"], res[1],
                                              err_msg=f"call {i} rank {r}")
        joined = _join([got[f"call{i}"]["state"] for got in per_rank])
        assert_state_dicts_match(state, joined)


def _join(blocks):
    if isinstance(blocks[0], dict):
        return {k: _join([b[k] for b in blocks]) for k in blocks[0]}
    return np.concatenate(blocks, axis=0)


def test_handoff_outcomes(ranks):
    """The expected flags of the mixed batch and the conflict batches."""
    mixed = ranks[("full_tail_mixed", 2)][0]["call0"]
    assert mixed["success"].tolist() == [True, False, True, True, False,
                                         False, True]
    assert mixed["new_ids"].tolist() == [3, 0, 4, 1, 0, 0, 1]
    conflicts = ranks[("merge_conflicts", 4)][0]
    assert [conflicts[f"call{i}"]["success"].tolist() for i in range(4)] == [
        [False, False], [False], [False, False], [True, False, False]]
    ties = _join([r["call0"]["state"] for r in ranks[("merge_quality_ties",
                                                      2)]])
    assert ties["feats"][6, 3, :, 0].tolist() == [7.0, 8.0, 9.0]


@pytest.mark.parametrize("world", (2, 4))
def test_dryrun_multichip_on_gloo(ranks, world):
    assert all(bool(r["ok"]) for r in ranks[("dryrun", world)])


def test_handoff_takes_one_rank_and_checks_its_entries():
    """On a world of one rank the payload is the owner's rows; entries of
    unequal length or on another device raise ValueError."""
    op, state, calls, _, _ = CASES["merge_union"]
    mesh = pmesh.scene_mesh(1, device="cpu")
    st = visual_state_from_numpy(jax_state_dict(state), "cpu")
    i32 = [torch.tensor(x, dtype=torch.int32) for x in calls[0]]
    merged, ok = phandoff.track_merge(mesh)(st, *i32)
    assert merged is st and ok.tolist() == [True]
    assert sorted(st.feat_quality[15, 2].tolist(), reverse=True) == \
        pytest.approx([0.9, 0.5, 0.4])
    with pytest.raises(ValueError, match="one length"):
        phandoff.track_migration(mesh)(st, i32[0], i32[1], i32[2],
                                       torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="on meta"):
        phandoff.track_migration(mesh)(st, *i32[:3], i32[3].to("meta"))
