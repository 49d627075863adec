"""The port's cross-shard gallery query (`parallel/gallery.py`) against the
JAX package's, across processes.

JAX runs `local_gallery_query` and `global_gallery_query` on 1-, 2- and
4-device scene meshes (and a 2x2 pod mesh) of forced host devices; the
port runs the same global state in one process and in gloo groups of 2
and 4 spawned ranks (tests/torch_dist_worker.py), each rank on its block.

The inputs carry ties: features with entries in {-1, 0, 1} and four
non-zero ones (norm 2, so every score is exact in f32 whatever the order
of its sums) repeat, queries repeat stored features, and one state has
fewer valid lanes than k (its -inf candidates tie).  Ties go to the lower
index, as `jax.lax.top_k` orders them.  A bf16 gallery is scored upcast
exactly, so it is held against JAX's query of the same values in f32.
Shard, scene and track indices must be equal; scores within
tests/torch_parity.py's RTOL/ATOL.  `merge_shard_topk` over the per-block
local results of 2, 4 and 8 blocks must equal the one-shard answer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from similari_tpu.parallel import gallery as jgallery
from similari_tpu.parallel import mesh as jmesh
from similari_tpu_torch.convert import visual_state_from_numpy
from similari_tpu_torch.parallel import gallery as pgallery
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.state import map_tensors

from torch_dist_worker import spawn
from torch_parity import ATOL, RTOL, jax_state_dict, one_cpu_thread

one_cpu_thread()

CPU = torch.device("cpu")
S, T, K, F, Q, TOPK = 8, 4, 3, 8, 6, 5
VARIANTS = ("ties", "sparse", "normal", "bf16")
KINDS = ("cosine", "euclidean")
WORLDS = (1, 2, 4)
POD = ("normal", "cosine")  # the case also run on the 2x2 pod mesh


def _signs(rng, n):
    """n vectors of F entries in {-1, 0, 1}, four non-zero: norm 2."""
    out = np.zeros((n, F), np.float32)
    for i in range(n):
        nz = rng.choice(F, 4, replace=False)
        out[i, nz] = rng.choice([-1.0, 1.0], 4)
    return out


def _case(variant):
    """(JAX state, the port's state dict, queries [Q, F], bf16)."""
    rng = np.random.default_rng(VARIANTS.index(variant))
    n = S * T * K
    if variant in ("ties", "sparse"):
        feats = _signs(rng, 24)[rng.integers(0, 24, n)]  # repeated rows
    else:
        feats = rng.normal(size=(n, F)).astype(np.float32)
    if variant == "bf16":
        feats = torch.tensor(feats).bfloat16().float().numpy()
    if variant == "sparse":
        fvalid = np.zeros(n, bool)
        fvalid[rng.choice(n, TOPK - 2, replace=False)] = True
        active = np.ones((S, T), bool)
    else:
        fvalid = rng.uniform(size=n) < 0.7
        active = rng.uniform(size=(S, T)) < 0.8
    lanes = np.flatnonzero(fvalid & np.repeat(active.reshape(-1), K))
    queries = np.concatenate([feats[rng.choice(lanes, Q - 2)],
                              _signs(rng, 2)])  # stored features first
    state = jmesh.new_batched_visual_state(S, T, 1, K, F)
    state = dataclasses.replace(
        state, feats=jnp.asarray(feats.reshape(S, T, K, F)),
        feat_valid=jnp.asarray(fvalid.reshape(S, T, K)),
        active=jnp.asarray(active),
        track_id=jnp.arange(1, S * T + 1, dtype=jnp.int32).reshape(S, T))
    return state, jax_state_dict(state), queries, variant == "bf16"


def _port_state(d, bf16):
    return visual_state_from_numpy(
        d, CPU, feature_dtype=torch.bfloat16 if bf16 else None)


def _jax_queries(variant, kind, world, hosts=0):
    state, _, queries, _ = _case(variant)
    mesh = (jmesh.pod_mesh(hosts, world // hosts) if hosts
            else jmesh.scene_mesh(world))
    state = jax.tree.map(lambda a: jax.device_put(
        a, NamedSharding(mesh, P(tuple(mesh.axis_names)))), state)
    q = jnp.asarray(queries)
    loc = jgallery.local_gallery_query(kind, TOPK, mesh)(state, q)
    glob = jgallery.global_gallery_query(kind, TOPK, mesh)(state, q)
    return [np.asarray(a) for a in loc], [np.asarray(a) for a in glob]


def _case_name(variant, kind, world, hosts=0):
    return f"{variant}_{kind}_{world}" + ("_pod" if hosts else "")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """case name -> every rank's port results (local and global)."""
    out = {}
    for world in (2, 4):
        cases, inputs = {}, {}
        todo = [(v, k, 0) for v in VARIANTS for k in KINDS]
        if world == 4:
            todo.append((*POD, 2))
        for variant, kind, hosts in todo:
            _, d, queries, bf16 = _case(variant)
            name = _case_name(variant, kind, world, hosts)
            cases[name] = "gallery"
            inputs[name] = dict(state=d, queries=queries, kind=np.array(kind),
                                k=np.array(TOPK), bf16=np.array(bf16),
                                pod_hosts=np.array(hosts))
        res = spawn(world, cases, inputs,
                    tmp_path_factory.mktemp(f"world{world}"))
        out.update({c: [r[c] for r in res] for c in cases})
    return out


def _port_one_rank(variant, kind):
    _, d, queries, bf16 = _case(variant)
    mesh = pmesh.scene_mesh(1, device="cpu")
    state, q = _port_state(d, bf16), torch.tensor(queries)
    loc = pgallery.local_gallery_query(kind, TOPK, mesh)(state, q)
    glob = pgallery.global_gallery_query(kind, TOPK, mesh)(state, q)
    return [{"local": dict(zip(("scores", "scene", "track"),
                               (a.numpy() for a in loc))),
             "global": dict(zip(("scores", "shard", "scene", "track"),
                                (a.numpy() for a in glob)))}]


def _check(per_rank, jax_local, jax_global):
    names = ("scores", "shard", "scene", "track")
    for r, res in enumerate(per_rank):
        for name, want in zip(names, jax_global):
            got = res["global"][name]
            if name == "scores":
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"rank {r} {name}")
        for name, want in zip(("scores", "scene", "track"), jax_local):
            want = want[r * Q:(r + 1) * Q]  # JAX stacks the shards' blocks
            got = res["local"][name]
            if name == "scores":
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_gallery_queries_match_jax(ranks, variant, kind, world):
    per_rank = (_port_one_rank(variant, kind) if world == 1
                else ranks[_case_name(variant, kind, world)])
    jax_local, jax_global = _jax_queries(variant, kind, world)
    _check(per_rank, jax_local, jax_global)
    if variant == "sparse":  # fewer valid lanes than k: -inf ties
        assert np.isneginf(jax_global[0][:, -1]).all()


def test_gallery_query_on_the_pod_mesh_matches_jax(ranks):
    per_rank = ranks[_case_name(*POD, 4, 2)]
    _check(per_rank, *_jax_queries(*POD, 4, hosts=2))
    # the exact stored features find themselves first
    assert (per_rank[0]["global"]["scores"][:Q - 2, 0] > 0.999).all()


@pytest.mark.parametrize("blocks", (2, 4, 8))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_merge_of_blocks_equals_one_shard(variant, kind, blocks):
    """The state split into blocks, each block's local top k, merged: the
    one-shard answer exactly, ties included."""
    _, d, queries, bf16 = _case(variant)
    state, q = _port_state(d, bf16), torch.tensor(queries)
    mesh = pmesh.scene_mesh(1, device="cpu")
    one = pgallery.global_gallery_query(kind, TOPK, mesh)(state, q)
    n = S // blocks
    local = pgallery.local_gallery_query(kind, TOPK, mesh)
    parts = [local(map_tensors(lambda a: a[b * n:(b + 1) * n], state), q)
             for b in range(blocks)]
    scores, scene, track = (torch.stack(x) for x in zip(*parts))
    shard = torch.arange(blocks, dtype=torch.int32)[:, None, None].expand(
        scene.shape)
    top, g_shard, g_scene, g_track = pgallery.merge_shard_topk(
        scores, shard, scene, track)
    assert torch.equal(top, one[0])
    assert torch.equal(g_shard * n + g_scene, one[2])
    assert torch.equal(g_track, one[3])


def test_stable_topk_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -np.inf, -np.inf, 2.0]])
    vals, idx = pgallery.stable_topk(x, 8)
    assert idx.tolist() == [[1, 2, 7, 0, 4, 3, 5, 6]]  # -0.0 below 0.0
    assert torch.equal(vals, x[:, idx[0]])
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    with pytest.raises(ValueError, match="kind"):
        pgallery.local_gallery_query("dot", 2, pmesh.scene_mesh(
            1, device="cpu"))(_port_state(_case("ties")[1], False),
                              torch.zeros(1, F))
