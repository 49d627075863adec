"""The port's last tools (`similari_tpu_torch/tools/{experiment_batch_merge,
experiment_pallas_batch,ablate_visual,gen_doc_tables}.py`) against the JAX
package, on the CPU.

- Merge forms: at a tiny S, T, K, F the three forms (`merge_lane`, one
  flattened `index_put_`, the merge kernel's plain version) give
  bit-equal states, equal to the JAX package's vmapped one-hot
  `merge_lane` and to its Pallas `lane_merge_inplace` in interpret mode.
- Fused batch: each scene of the n-scene loop gives the ids of that scene
  run alone; scene 0 gives JAX's `pallas_visual_chunk` (interpret mode)
  ids at a tiny shape.
- Ablation: at S=2 and the bench's widths the warmed state equals JAX's
  batched step's, and each stage equals the JAX stage functions on the
  same inputs (`positional_weights`, `visual_votes`, the auction's
  columns, the merged state: integers exactly, floats at tests/
  torch_parity.py's RTOL/ATOL, the vote weights at the bound
  tests/test_torch_visual_step.py holds the gram-form distances to);
  `main` prints every stage and the rest.
- Doc tables: only the `port-*` blocks of a README copy change; an
  artifact without a card's `device` gives exit code 1 and no write;
  `fmt` is the JAX tool's.
"""

import dataclasses
import importlib.util
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops import assignment as jasg
from similari_tpu.ops import merge as jmrg
from similari_tpu.ops import pallas_visual as jpv
from similari_tpu.ops.pallas_merge import lane_merge_inplace as jax_merge
from similari_tpu.parallel import mesh as jmesh
from similari_tpu.trackers import visual_step as JV
from similari_tpu.trackers.visual_state import new_visual_state as jax_state
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.convert import visual_state_to_numpy
from similari_tpu_torch.tools import ablate_visual as abl
from similari_tpu_torch.tools import experiment_batch_merge as ebm
from similari_tpu_torch.tools import experiment_pallas_batch as epb
from similari_tpu_torch.tools import gen_doc_tables as gdt
from similari_tpu_torch.trackers.visual_step import VisualConfig

from torch_parity import (ATOL, RTOL, assert_state_dicts_match,
                          jax_state_dict, one_cpu_thread)

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the JAX tools' VisualSORT configuration (experiment_pallas_batch.py,
# ablate_visual.py)
CFG = dict(positional_kind="iou", visual_kind="euclidean",
           visual_threshold=100.0, visual_minimal_track_length=3,
           max_idle_epochs=5, assignment="auction", oriented=False,
           feature_precision="bf16")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tools_use_the_jax_tools_configuration():
    assert epb.CONFIG == abl.CONFIG == VisualConfig(**CFG)


# --------------------------------------------------------------------------
# experiment_batch_merge
# --------------------------------------------------------------------------

# S, T, K, F, D, L: F=256 is the JAX Pallas merge's bf16 minimum
MERGE_SHAPE = (3, 10, 3, 256, 6, 4)


@pytest.fixture(scope="module")
def merge_runs():
    s, t, k, f, d, steps = MERGE_SHAPE
    arrays = ebm.make_inputs(s, t, k, f, d, steps, seed=1)
    results, finals, launches = ebm.experiment(
        CPU, ebm.to_device(arrays, CPU), reps=1)
    return arrays, results, finals


def _jax_merges(arrays):
    """The JAX tool's `onehot` and `pallas` bodies over the steps."""
    feats0, src, slot, lane, valid = arrays
    s, t, k, f = feats0.shape
    onehot = jnp.asarray(feats0).astype(jnp.bfloat16)
    pallas = onehot
    srcj = jnp.asarray(src).astype(jnp.bfloat16)
    for i in range(slot.shape[0]):
        hit = jax.vmap(jmrg.writer_hit, in_axes=(0, 0, None))(
            jnp.asarray(slot[i]), jnp.asarray(valid[i]).astype(bool), t)
        onehot = jax.vmap(jmrg.merge_lane)(onehot, srcj[i],
                                           jnp.asarray(lane[i]), hit)
        pallas = jax_merge(pallas.reshape(s, t * k, f), srcj[i],
                           jnp.asarray(slot[i] * k + lane[i]),
                           jnp.asarray(valid[i]),
                           interpret=True).reshape(s, t, k, f)
    return {"onehot": onehot, "pallas": pallas}


@pytest.mark.parametrize("form", ebm.VARIANTS)
def test_merge_form_is_bit_equal_to_the_kernel_form(merge_runs, form):
    arrays, results, finals = merge_runs
    assert torch.equal(finals[form], finals["kernel"])
    assert results[form] > 0
    # the steps wrote something
    start = torch.as_tensor(arrays[0]).bfloat16()
    assert not torch.equal(finals[form], start)


@pytest.mark.parametrize("jax_form", ["onehot", "pallas"])
def test_merge_forms_equal_the_jax_merges(merge_runs, jax_form):
    arrays, _, finals = merge_runs
    want = np.asarray(_jax_merges(arrays)[jax_form]).astype(np.float32)
    for form, got in finals.items():
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=form)


# --------------------------------------------------------------------------
# experiment_pallas_batch
# --------------------------------------------------------------------------

# chunk, D, T, K, F
FUSED_SHAPE = (4, 8, 32, 3, 16)


@pytest.fixture(scope="module")
def fused_runs():
    chunk, d, t, k, f = FUSED_SHAPE
    per_frame, first, launches, all_args = epb.measure(
        CPU, 2, iters=1, reps=1, shape=FUSED_SHAPE)
    alone = epb.lone_ids(CPU, all_args, t=t, k=k, f=f)
    return per_frame, first, alone, all_args


@pytest.mark.parametrize("scene", [0, 1])
def test_fused_batch_scene_equals_its_lone_run(fused_runs, scene):
    per_frame, first, alone, _ = fused_runs
    assert per_frame > 0
    assert first[scene].shape == FUSED_SHAPE[:2]
    assert torch.equal(first[scene], alone[scene])
    assert (first[scene] > 0).all()


def test_fused_batch_scenes_differ(fused_runs):
    _, _, _, all_args = fused_runs
    assert not torch.equal(all_args[0][0], all_args[1][0])


def test_fused_batch_scene_zero_matches_jax_pallas(fused_runs):
    chunk, d, t, k, f = FUSED_SHAPE
    _, first, _, all_args = fused_runs
    call = jpv.pallas_visual_chunk(JaxVisualConfig(**CFG), chunk, d, t, k,
                                   f, interpret=True)
    st = jpv.state_to_tuple(jax_state(t, 1, k, f))
    out = call(st, *(jnp.asarray(x.numpy()) for x in all_args[0]),
               jnp.ones((1, 1), jnp.int32))
    np.testing.assert_array_equal(first[0].numpy(),
                                  np.asarray(out[len(st)]))


# --------------------------------------------------------------------------
# ablate_visual
# --------------------------------------------------------------------------

ABL_SCENES = 2


@pytest.fixture(scope="module")
def ablation():
    """(port inputs, port warm state, JAX warm state)."""
    inp = abl.make_inputs(ABL_SCENES, CPU)
    warm = abl.warm_state(abl.CONFIG, inp)
    s, d, f = inp.feat.shape
    vstep = jax.jit(jmesh.batched_visual_step(JaxVisualConfig(**CFG)))
    jwarm = jmesh.new_batched_visual_state(s, 2 * d, 1, abl.GALLERY, f,
                                           feature_dtype=jnp.bfloat16)
    ones, tru = jnp.ones((s, d)), jnp.ones((s, d), bool)
    for i in range(abl.WARM_STEPS):
        jwarm, _ = vstep(jwarm, jnp.asarray(inp.boxes[i].numpy()), ones, tru,
                         jnp.asarray(inp.feat.numpy()), tru, ones, ones,
                         jnp.full((s,), 1 + i, jnp.int32))
    return inp, warm, jwarm


def _jax_box(inp, i):
    return jnp.asarray(inp.boxes[i].numpy())


def test_warm_state_matches_jax(ablation):
    _, warm, jwarm = ablation
    assert_state_dicts_match(jax_state_dict(jwarm),
                             visual_state_to_numpy(warm))
    assert bool(warm.active.any())


def _jax_positional(jcfg, jst, box, epoch):
    def one(st, b, e):
        compat = JV._compat_matrix(jcfg, st, b, e)
        return JV.positional_weights(jcfg, st, b, jnp.ones(b.shape[0]),
                                     compat)

    return jax.vmap(one)(jst, box, epoch)


def test_positional_stage_matches_jax(ablation):
    inp, warm, jwarm = ablation
    p, v = abl.positional_stage(abl.CONFIG, warm, inp.boxes[1], inp.ones,
                                abl.epochs(inp, 5))
    jp, jv = _jax_positional(JaxVisualConfig(**CFG), jwarm, _jax_box(inp, 1),
                             jnp.full((ABL_SCENES,), 5, jnp.int32))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    assert bool(v.any())


def test_votes_stage_matches_jax(ablation):
    inp, warm, jwarm = ablation
    jcfg = JaxVisualConfig(**CFG)
    feat = inp.feat * (1.0 + 1e-6 * 3)
    n, w = abl.votes_stage(abl.CONFIG, warm, inp.boxes[2], feat, inp.tru,
                           abl.epochs(inp, 6))

    def one(st, b, f, e):
        compat = JV._compat_matrix(jcfg, st, b, e)
        return JV.visual_votes(jcfg, st, f, jnp.ones(b.shape[0], bool),
                               compat)

    jn, jw = jax.vmap(one)(jwarm, _jax_box(inp, 2),
                           jnp.asarray(feat.numpy()),
                           jnp.full((ABL_SCENES,), 6, jnp.int32))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    # a weight sums K distances of the gram form, whose rounding scales
    # with the norms (tests/test_torch_visual_step.py's distance bound)
    scale = float(feat.abs().sum(-1).max() * warm.feats.float().abs().max())
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=abl.GALLERY * ATOL * scale)
    assert int(n.sum()) > 0


def test_auction_stage_matches_jax(ablation):
    inp, warm, _ = ablation
    p, v = abl.positional_stage(abl.CONFIG, warm, inp.boxes[0], inp.ones,
                                abl.epochs(inp, 5))
    w = torch.where(v, p, 0.0) * (1.0 + 1e-5 * 2)
    col_open = torch.ones(warm.active.shape, dtype=torch.bool)
    col = abl.auction_stage(abl.CONFIG, w, inp.tru, col_open)
    thr = abl.CONFIG.new_track_threshold
    jcol = jax.vmap(lambda x: jasg.solve_voting(
        x, thr, jnp.ones(x.shape[0], bool), jnp.ones(x.shape[1], bool),
        "auction"))(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    assert int((col >= inp.tru.shape[1]).sum()) > 0  # rows matched


def _jax_merge_step(jst, box, feat0, slot):
    """The JAX tool's `mergeonly` body for one step."""
    t = jst.active.shape[1]
    d = slot.shape[1]

    def one(s_, b_, sl_):
        tru = jnp.ones((d,), bool)
        hit = jmrg.writer_hit(sl_, tru, t)
        hix = jnp.zeros((d,), jnp.int32)
        return dataclasses.replace(
            s_,
            pred_box=jmrg.merge_rows(s_.pred_box, b_, hit),
            obs_box=jmrg.merge_rows(s_.obs_box, b_, hit),
            conf=jmrg.merge_rows(s_.conf, jnp.ones((d,)), hit),
            length=jmrg.merge_rows(s_.length, 1 + 0 * sl_, hit),
            track_id=jmrg.merge_rows(s_.track_id, sl_, hit),
            feats=jmrg.merge_lane(s_.feats, feat0, hix, hit),
            feat_quality=jmrg.merge_rows(
                s_.feat_quality,
                jnp.zeros((d, s_.gallery_size), jnp.float32), hit),
            hist_feat=jmrg.merge_ring(s_.hist_feat, feat0, hix, hit),
            collected=jmrg.merge_rows(s_.collected, 1 + 0 * sl_, hit),
        )

    return jax.vmap(one)(jst, box, slot)


def test_merge_stage_matches_jax(ablation):
    inp, _, _ = ablation
    s, d, f = inp.feat.shape
    st = abl.fresh_state(inp)
    jst = jmesh.new_batched_visual_state(s, 2 * d, 1, abl.GALLERY, f,
                                         feature_dtype=jnp.bfloat16)
    src = inp.feat[0].to(torch.bfloat16).expand(s, d, f).contiguous()
    feat0 = jnp.asarray(inp.feat[0].numpy())
    for i in (0, 3):
        slot = abl.merge_slots(inp, i)
        st = abl.merge_stage(st, inp.boxes[i], inp.ones, src, slot)
        jst = _jax_merge_step(jst, _jax_box(inp, i), feat0,
                              jnp.asarray(slot.numpy()))
    assert_state_dicts_match(jax_state_dict(jst), visual_state_to_numpy(st))


def test_ablation_main_prints_every_stage(capsys):
    assert abl.main([str(ABL_SCENES), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    stages = ["full", "posonly", "votesonly", "auctiononly", "mergeonly"]
    assert list(line["ms_per_step"]) == stages
    assert all(v > 0 for v in line["ms_per_step"].values())
    assert line["rest_ms"] == pytest.approx(
        line["ms_per_step"]["full"] - sum(line["ms_per_step"][k]
                                          for k in stages[1:]), abs=1e-4)
    assert line["device"] == "cpu" and line["scenes"] == ABL_SCENES
    for stage in stages:
        assert any(ln.startswith(f"{stage:12s}:") for ln in out)
    assert any(ln.startswith("KF+bestfit+rest") for ln in out)


# --------------------------------------------------------------------------
# gen_doc_tables
# --------------------------------------------------------------------------

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PORT_BLOCK = re.compile(r"(<!-- BEGIN GENERATED: (port-[a-z-]+) -->\n)"
                        r".*?(<!-- END GENERATED: \2 -->)", re.S)


def _artifacts(tmp_path, device=CARD):
    """Artifacts of the port's entry points, in their formats, with
    `device`."""
    bench = {"metric": "batch_visual_sort_scene_fps", "value": 25005.0,
             "device": device,
             "extra": {"sort_iou_100_fps": 184.4,
                       "batch_visual_256x100x512_fps": 25005.0,
                       "visual_sort_100x512_pallas_fps": 5572.0,
                       "nms_1000_fps": 930.8}}
    inter = json.loads((ROOT / "INTERACTIVE_r05.json").read_text())
    inter.update(device=device, engine="host")
    adv = json.loads((ROOT / "ADVERSARIAL_r05.json").read_text())
    adv["device"] = device
    margins = json.loads((ROOT / "MARGINS_r05.json").read_text())
    margins["device"] = device
    paths = {}
    for name, blob, stdout in (("bench", bench, True),
                               ("interactive", inter, True),
                               ("adversarial", adv, False),
                               ("margins", margins, False)):
        p = tmp_path / f"{name}.json"
        # the harnesses' stdout lines, the tools' --out files
        p.write_text(("log line\n" + json.dumps(blob) + "\n") if stdout
                     else json.dumps(blob, indent=1))
        paths[name] = p
    return paths


def _args(paths, readme):
    return ["--device", "cpu", "--readme", str(readme)] + [
        x for k, p in paths.items() for x in (f"--{k}", str(p))]


def _strip_port_blocks(text):
    return PORT_BLOCK.sub(lambda m: m.group(1) + m.group(3), text)


def test_doc_tables_change_only_the_port_blocks(tmp_path, capsys):
    readme = tmp_path / "README.md"
    shutil.copy(ROOT / "README.md", readme)
    before = readme.read_text()
    assert gdt.main(_args(_artifacts(tmp_path), readme)) == 0
    after = readme.read_text()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line["blocks"]) == sorted(
        ["port-headline", "port-full-matrix", "port-adversarial",
         "port-margins", "port-interactive-ranges"])
    assert _strip_port_blocks(after) == _strip_port_blocks(before)
    blocks = {m.group(2): m.group(0) for m in PORT_BLOCK.finditer(after)}
    for name in line["blocks"]:
        assert CARD in blocks[name], name
    assert "25.0k scene-frames/s" in blocks["port-headline"]
    assert "| NMS, 1000 boxes | 72 | 931 frames/s | 12.9x |" in \
        blocks["port-full-matrix"]
    # the JAX-era blocks are untouched
    for name in ("headline", "interactive-ranges"):
        pat = re.compile(rf"<!-- BEGIN GENERATED: {name} -->.*?"
                         rf"<!-- END GENERATED: {name} -->", re.S)
        assert pat.search(after).group(0) == pat.search(before).group(0)


@pytest.mark.parametrize("artifact", ["bench", "interactive", "adversarial",
                                      "margins"])
def test_doc_tables_refuse_an_artifact_without_a_card(tmp_path, artifact):
    readme = tmp_path / "README.md"
    shutil.copy(ROOT / "README.md", readme)
    before = readme.read_text()
    paths = _artifacts(tmp_path)
    cpu_dir = tmp_path / "cpu"
    cpu_dir.mkdir()
    paths[artifact] = _artifacts(cpu_dir, "cpu")[artifact]
    assert gdt.main(_args(paths, readme)) == 1
    assert readme.read_text() == before


@pytest.mark.parametrize("value", [0.4, 3.0, 999.4, 1000.0, 25005.0,
                                   999_999.0, 1e6, 2.5e7])
def test_fmt_matches_the_jax_tool(value):
    assert gdt.fmt(value) == _load("gen_doc_tables").fmt(value)


def test_doc_tables_name_the_jax_tools_reference_rows():
    jgdt = _load("gen_doc_tables")
    assert gdt.REF == jgdt.REF and gdt.HEADLINE == jgdt.HEADLINE
