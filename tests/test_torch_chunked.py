"""The port's scene-chunked batched steps (`parallel/mesh.py::
batched_sort_step_chunked`, `batched_visual_step_chunked`) against its
unchunked steps and the JAX package's chunked steps, on the CPU.

Chunking only bounds one step's temporaries, so ids, slots, is_new,
voting types and overflow flags must equal the unchunked step's exactly,
states to torch_parity.RTOL/ATOL (the port's unchunked step runs the same
arithmetic per scene: they are equal bit for bit here).  Scenes 16,
chunk 4, as tests/test_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.parallel import mesh as jmesh
from similari_tpu.trackers.sort_step import SortConfig as JaxSortConfig
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.convert import (sort_state_from_numpy,
                                        sort_state_to_numpy,
                                        visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.parallel import (batched_sort_step,
                                         batched_sort_step_chunked,
                                         batched_visual_step,
                                         batched_visual_step_chunked)
from similari_tpu_torch.parallel import mesh as pmesh
from similari_tpu_torch.trackers.sort_step import SortConfig
from similari_tpu_torch.trackers.state import map_tensors
from similari_tpu_torch.trackers.visual_step import VisualConfig

from torch_parity import (VISUAL_CONFIGS, assert_state_dicts_match,
                          jax_state_dict, one_cpu_thread)

one_cpu_thread()

CPU = torch.device("cpu")
S, CHUNK, D, T, K, F, FRAMES = 16, 4, 6, 16, 3, 8, 3
SCFG = dict(method="iou", assignment="auction", max_idle_epochs=5,
            oriented=False)
VCFG = dict(VISUAL_CONFIGS["euclid_iou"], recycle_idle=True)
SORT_OUT = ("slot", "track_id", "is_new", "length", "overflow")
VISUAL_OUT = SORT_OUT + ("voting_type",)


def _frames(seed, f=0):
    """FRAMES frames of S scenes x D random-walk boxes (tests/
    test_parallel.py's boxes), with fixed identities + noise when f > 0."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (S, D, 2))
    ident = rng.normal(size=(S, D, max(f, 1))).astype(np.float32)
    out = []
    for i in range(FRAMES):
        xy += rng.uniform(-2, 2, xy.shape)
        box = np.zeros((S, D, 5), np.float32)
        box[..., :2] = xy
        box[..., 3] = 0.5
        box[..., 4] = 20.0
        conf = np.ones((S, D), np.float32)
        valid = np.ones((S, D), bool)
        valid[i % S, : D // 2] = False
        args = [box, conf, valid]
        if f:
            feat = ident + 0.05 * rng.normal(size=ident.shape).astype(
                np.float32)
            args += [feat[..., :f], valid.copy(), conf, conf]
        out.append((args, np.full(S, i + 1, np.int32)))
    return out


def _run(step, state, frames, to_tensor):
    outs = []
    for args, ep in frames:
        state, out = step(state, *map(to_tensor, args), to_tensor(ep))
        outs.append(out)
    return state, outs


def _leaves(obj):
    out = []
    map_tensors(lambda t: out.append(t) or t, obj)
    return out


def _same_outputs(got, want, names):
    for i, (a, b) in enumerate(zip(got, want)):
        for name in names:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                err_msg=f"frame {i} {name}")


@pytest.mark.parametrize("kind", ["sort", "visual"])
def test_chunked_step_matches_unchunked_and_jax(kind):
    if kind == "sort":
        frames = _frames(9)
        js = jmesh.new_batched_state(S, T, 1)
        jchunked = jmesh.batched_sort_step_chunked(JaxSortConfig(**SCFG),
                                                   CHUNK)
        full = batched_sort_step(SortConfig(**SCFG))
        chunked = batched_sort_step_chunked(SortConfig(**SCFG), CHUNK)
        start, to_np, names = sort_state_from_numpy, sort_state_to_numpy, \
            SORT_OUT
    else:
        frames = _frames(10, F)
        js = jmesh.new_batched_visual_state(S, T, 1, K, F)
        jchunked = jmesh.batched_visual_step_chunked(
            JaxVisualConfig(**VCFG), CHUNK)
        full = batched_visual_step(VisualConfig(**VCFG))
        chunked = batched_visual_step_chunked(VisualConfig(**VCFG), CHUNK)
        start, to_np, names = visual_state_from_numpy, \
            visual_state_to_numpy, VISUAL_OUT
    ps0 = start(jax_state_dict(js), CPU)
    sj, oj = _run(jax.jit(jchunked), js, frames, jnp.asarray)
    sf, of = _run(full, map_tensors(torch.clone, ps0), frames, torch.tensor)
    sc, oc = _run(chunked, map_tensors(torch.clone, ps0), frames,
                  torch.tensor)
    _same_outputs(oc, of, names)
    _same_outputs(oc, oj, names)
    assert_state_dicts_match(to_np(sc), to_np(sf))
    assert_state_dicts_match(jax_state_dict(sj), to_np(sc))
    assert (~oc[-1].is_new).any()  # tracks carried across frames


@pytest.mark.parametrize("kind", ["sort", "visual"])
def test_chunked_step_leaves_its_input_state(kind):
    """The input states are not written, and each slice's results are its
    own: a second call from the same input state gives the same result."""
    if kind == "sort":
        frames = _frames(9)
        st = pmesh.new_batched_state(S, T, 1, device=CPU)
        step = batched_sort_step_chunked(SortConfig(**SCFG), CHUNK)
    else:
        frames = _frames(10, F)
        st = pmesh.new_batched_visual_state(S, T, 1, K, F, device=CPU)
        step = batched_visual_step_chunked(VisualConfig(**VCFG), CHUNK)
    st, _ = _run(step, st, frames[:1], torch.tensor)
    before = map_tensors(torch.clone, st)
    args, ep = frames[1]
    a, oa = step(st, *map(torch.tensor, args), torch.tensor(ep))
    b, ob = step(st, *map(torch.tensor, args), torch.tensor(ep))
    for x, y in ((st, before), (a, b), (oa, ob)):
        assert all(map(torch.equal, _leaves(x), _leaves(y)))
    assert not all(map(torch.equal, _leaves(a), _leaves(st)))


def test_chunk_scenes_direct_path_and_errors():
    """S <= chunk calls the step once on the whole batch; S not a multiple
    of the chunk raises ValueError (not assert, which -O strips)."""
    calls = []

    def spy(states, *args):
        calls.append(states.active.shape[0])
        return states, states

    st = pmesh.new_batched_state(S, T, 1, device=CPU)
    for chunk, want in ((S, [S]), (S + 5, [S]), (4, [4] * 4), (8, [8, 8])):
        calls.clear()
        out_st, _ = pmesh._chunk_scenes(spy, chunk)(st, torch.zeros(S))
        assert calls == want
        assert torch.equal(out_st.active, st.active)
    with pytest.raises(ValueError, match="multiple"):
        pmesh._chunk_scenes(spy, 5)(st, torch.zeros(S))
