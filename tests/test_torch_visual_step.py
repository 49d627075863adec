"""The port's general VisualSORT step and its feature distances against the
JAX package, on the CPU.

Ids, slots, voting types, is_new, lengths, overflow flags and next_id must
be equal; boxes and Kalman state are held at torch_parity.RTOL/ATOL (XLA
may contract a multiply-add that PyTorch rounds twice), gallery lanes and
the feature history at torch_parity.GALLERY_TOL.  Both packages name their
assignment backend: the JAX package's "auto" may pick its native solver
on the CPU.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.eval import mot as jmot
from similari_tpu.ops import distances as jdst
from similari_tpu.trackers.visual_state import new_visual_state as jax_new_state
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu.trackers.visual_step import (compiled_visual_scan,
                                               visual_step_deferred as
                                               jax_visual_step_deferred)
from similari_tpu_torch.convert import (visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.eval import mot as pmot
from similari_tpu_torch.ops import distances as dst
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import (VT_VISUAL, VisualConfig,
                                                     visual_scan,
                                                     visual_step_deferred)

from torch_parity import (ATOL, GALLERY_TOL, RTOL, VISUAL_CONFIGS,
                          assert_state_dicts_match, crowded_stream,
                          jax_state_dict, large_norm_stream, one_cpu_thread,
                          oriented_visual_stream, visual_overflow_stream,
                          visual_padded_stream, visual_stream)

one_cpu_thread()

CPU = torch.device("cpu")
OUTPUTS = ("slot", "track_id", "is_new", "length", "voting_type", "overflow")
STEPS, D, T, K, F = 8, 8, 32, 3, 16
GAPS = np.array([1, 2, 3, 7, 8, 9, 20, 21], np.int32)


# --------------------------------------------------------------------------
# distances
# --------------------------------------------------------------------------

def _features(kind):
    rng = np.random.default_rng(4)
    if kind == "large_norm":  # the gram form's f32 cancellation regime
        feat = large_norm_stream(2, 6, 32)[3]
        return feat[0], np.stack([feat[1], feat[0], feat[1][::-1]], axis=1)
    return (rng.normal(size=(6, 32)).astype(np.float32),
            rng.normal(size=(5, 3, 32)).astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "large_norm"])
@pytest.mark.parametrize("metric,precision", [
    ("euclidean", "f32"), ("euclidean", "bf16"), ("cosine", "f32"),
    ("cosine", "bf16")])
def test_distance_matrices_match_jax(kind, metric, precision):
    """bf16 rounds both sides first; the product and the norms are taken
    of the rounded values in f32, as the JAX package does."""
    q, g = _features(kind)
    jq, jg = jnp.asarray(q), jnp.asarray(g)
    tq, tg = torch.tensor(q), torch.tensor(g)
    if precision == "bf16":
        jq, jg = jq.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
        tq, tg = tq.to(torch.bfloat16), tg.to(torch.bfloat16)
    jfn = jdst.euclidean_matrix if metric == "euclidean" else jdst.cosine_matrix
    pfn = dst.euclidean_matrix if metric == "euclidean" else dst.cosine_matrix
    j = np.asarray(jfn(jq, jg))
    p = pfn(tq, tg).numpy()
    assert p.shape == (6,) + g.shape[:2] and p.dtype == np.float32
    # the gram form's rounding scales with the norms
    scale = float(np.abs(q).sum(1).max() * np.abs(g).max())
    np.testing.assert_allclose(p, j, rtol=RTOL,
                               atol=ATOL * (scale if metric == "euclidean"
                                            else 1.0))
    # a leading scene axis gives each scene's own matrix
    both = pfn(torch.stack([tq, tq.flip(0)]), torch.stack([tg, tg]))
    np.testing.assert_array_equal(both[0].numpy(), p)
    np.testing.assert_array_equal(both[1].numpy(),
                                  pfn(tq.flip(0), tg).numpy())


def test_scalar_distances_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=7).astype(np.float32)
    b = rng.normal(size=9).astype(np.float32)
    assert dst.euclidean(a, b) == pytest.approx(jdst.euclidean(a, b),
                                                rel=1e-6)
    assert dst.cosine(a, b) == pytest.approx(jdst.cosine(a, b), rel=1e-6)


# --------------------------------------------------------------------------
# the general step against the JAX package's visual_scan
# --------------------------------------------------------------------------

def _run_both(cfg_kw, stream, t, h=1, epochs=1, bf16_storage=False):
    """Both packages' general scans from the same empty state."""
    fdt = jnp.bfloat16 if bf16_storage else jnp.float32
    st = jax_new_state(t, h, K, stream[3].shape[2], feature_dtype=fdt)
    start = jax_state_dict(st)
    sj, oj = compiled_visual_scan(JaxVisualConfig(**cfg_kw))(
        st, *(jnp.asarray(x) for x in stream), jnp.asarray(epochs))
    sp, op = visual_scan(
        VisualConfig(**cfg_kw),
        visual_state_from_numpy(
            start, CPU, torch.bfloat16 if bf16_storage else None),
        *(torch.tensor(x) for x in stream), epochs)
    return (jax_state_dict(sj), oj), (visual_state_to_numpy(sp), op)


AUCTION = dict(VISUAL_CONFIGS["euclid_iou"])
PADDED = dict(positional_kind="iou", oriented=False, assignment="auction",
              visual_kind="cosine", visual_threshold=0.5,
              visual_minimal_track_length=1, max_idle_epochs=10,
              feature_precision="bf16", recycle_idle=True)

CASES = {
    **{f"{name}_{seed}": (VISUAL_CONFIGS[name],
                          lambda seed=seed: visual_stream(seed, STEPS, D, F),
                          {}) for name in VISUAL_CONFIGS for seed in (0, 1)},
    "oriented": (dict(AUCTION, oriented=True),
                 lambda: oriented_visual_stream(0, STEPS, D, F), {}),
    "oriented_maha_hungarian": (
        dict(VISUAL_CONFIGS["maha"], oriented=True, assignment="hungarian"),
        lambda: oriented_visual_stream(1, STEPS, D, F), {}),
    "history3": (dict(AUCTION, oriented=True),
                 lambda: oriented_visual_stream(2, STEPS, D, F), dict(h=3)),
    "own_area": (dict(AUCTION, oriented=True, own_area_use=0.4,
                      own_area_collect=0.6),
                 lambda: oriented_visual_stream(3, STEPS, D, F, spread=90.0),
                 {}),
    "cosine_bf16": (dict(VISUAL_CONFIGS["cosine_gates"],
                         feature_precision="bf16"),
                    lambda: visual_stream(2, STEPS, D, F),
                    dict(bf16_storage=True)),
    "overflow": (dict(AUCTION, max_idle_epochs=2),
                 lambda: visual_overflow_stream(STEPS, D, F), dict(t=8)),
    "overflow_recycle": (dict(AUCTION, max_idle_epochs=2, recycle_idle=True),
                         lambda: visual_overflow_stream(STEPS, D, F),
                         dict(t=8)),
    "padded": (PADDED, lambda: visual_padded_stream(12, 16, F), dict(t=64)),
    "crowded": (AUCTION, lambda: crowded_stream(0, STEPS, 16, 12, F, 133.0,
                                                noise=2.0, copies=1),
                dict(t=64)),
    "large_norm": (dict(AUCTION, visual_threshold=1e4,
                        visual_minimal_track_length=1),
                   lambda: large_norm_stream(STEPS, D, F), {}),
    "gaps": (dict(AUCTION, max_idle_epochs=3),
             lambda: visual_stream(3, STEPS, D, F), dict(epochs=GAPS)),
    "hungarian": (dict(AUCTION, assignment="hungarian"),
                  lambda: visual_stream(4, STEPS, D, F), {}),
}


@pytest.fixture(scope="module")
def runs():
    """One run of both packages per case, shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, make, opts = CASES[case]
            stream = make()
            opts = dict(opts)
            t = opts.pop("t", T)
            cache[case] = (stream[2], *_run_both(kw, stream, t, **opts))
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_visual_scan_matches_jax(runs, case):
    valid, (sj, oj), (sp, op) = runs(case)
    for name in OUTPUTS:
        np.testing.assert_array_equal(getattr(op, name).numpy(),
                                      np.asarray(getattr(oj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(op.pred_box.numpy()[valid],
                               np.asarray(oj.pred_box)[valid],
                               rtol=RTOL, atol=ATOL)
    assert_state_dicts_match(sj, sp)
    assert np.isfinite(sp["pred_box"]).all()


@pytest.mark.parametrize("case,check", [
    ("overflow", "overflow"), ("overflow_recycle", "overflow"),
    ("crowded", "contended"), ("large_norm", "visual"),
    ("own_area", "gated"), ("history3", "ring"), ("euclid_iou_0", "visual")])
def test_visual_scan_regimes_are_exercised(runs, case, check):
    """Each stream reaches the regime it is there for."""
    valid, _, (sp, op) = runs(case)
    vt = op.voting_type.numpy()
    if check == "overflow":
        assert op.overflow.any() and not op.overflow[0]
    elif check == "contended":  # most rows join a track
        assert (~op.is_new.numpy() & valid).sum() > valid.sum() // 2
    elif check == "visual":
        assert (vt[3:][valid[3:]] == VT_VISUAL).mean() > 0.5
    elif check == "gated":
        # own-area gates turn some matches from visual to positional
        _, _, (_, free) = runs("oriented")
        assert (vt == VT_VISUAL).sum() < (free.voting_type.numpy()
                                          == VT_VISUAL).sum()
    elif check == "ring":
        assert sp["hist_feat_valid"].sum(1).max() == 3


def test_visual_step_deferred_matches_jax():
    """The deferred merge operands: rows and masks equal, the source rows
    within tolerance; the state leaves the big feature arrays as they
    were."""
    kw = dict(AUCTION, recycle_idle=True)
    stream = visual_stream(5, STEPS, D, F)
    (sj, _), (sp, _) = _run_both(kw, [x[:5] for x in stream], T)
    frame = [x[5] for x in stream]
    jst = _jax_state_from_dict(sj, jax_new_state(T, 1, K, F))
    _, jout, jmerge = jax.jit(partial(jax_visual_step_deferred,
                                      JaxVisualConfig(**kw)))(
        jst, *(jnp.asarray(x) for x in frame), jnp.int32(6))
    pst = visual_state_from_numpy(sp, CPU)
    new, pout, pmerge = visual_step_deferred(
        VisualConfig(**kw), pst, *(torch.tensor(x) for x in frame), 6)
    for name in ("feats", "hist_feat"):  # the same storage, unchanged
        assert getattr(new, name).data_ptr() == getattr(pst, name).data_ptr()
        assert torch.equal(getattr(new, name), getattr(pst, name))
    np.testing.assert_array_equal(pout.track_id.numpy(),
                                  np.asarray(jout.track_id))
    np.testing.assert_allclose(pmerge[0].numpy(), np.asarray(jmerge[0]),
                               rtol=GALLERY_TOL, atol=GALLERY_TOL)
    for i in range(1, 5):
        np.testing.assert_array_equal(pmerge[i].numpy(),
                                      np.asarray(jmerge[i]), err_msg=str(i))
        assert pmerge[i].dtype == torch.int32
    assert pmerge[2].sum() > 0


def _jax_state_from_dict(d, template):
    """A JAX state with the values of the numpy dict `d`."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if f.name == "kf":
            kw["kf"] = type(v)(**{k: jnp.asarray(d["kf"][k]) for k in d["kf"]})
        else:
            kw[f.name] = jnp.asarray(d[f.name]).astype(v.dtype)
    return type(template)(**kw)


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------

def _sequence(seed, frames=(1, 2, 3, 5, 6, 7, 10, 11, 12, 13)):
    rng = np.random.default_rng(seed)
    n, f = 7, 12
    xy = rng.uniform(0, 200, (n, 2))
    ident = rng.normal(size=(n, f))
    dets, feats = {}, {}
    for fr in frames:
        xy += rng.uniform(-3, 3, xy.shape)
        keep = rng.uniform(size=n) < 0.9
        dets[fr] = [(float(x) - 12, float(y) - 20, 24.0, 40.0,
                     float(rng.uniform(0.5, 1)))
                    for (x, y), k in zip(xy, keep) if k]
        feats[fr] = [list(ident[i] + 0.1 * rng.normal(size=f))
                     if rng.uniform() < 0.9 else None
                     for i in range(n) if keep[i]]
    return dets, feats


@pytest.mark.parametrize("assignment,extra", [
    ("auction", {}), ("hungarian", {}),
    ("auction", dict(own_area_use=0.3, own_area_collect=0.5))])
def test_runner_step_engine_matches_jax(assignment, extra):
    dets, feats = _sequence(0)
    kw = dict(capacity=16, assignment=assignment, **extra)
    out_j, _ = jmot.run_sequence_device_visual(dets, feats, engine="xla",
                                               **kw)
    out_p, fps = pmot.run_sequence_device_visual(dets, feats, engine="step",
                                                 device="cpu", **kw)
    assert out_p.keys() == out_j.keys() and fps > 0
    for fr in out_j:
        assert [r[0] for r in out_p[fr]] == [r[0] for r in out_j[fr]], fr
        np.testing.assert_allclose(np.array([r[1:] for r in out_p[fr]]),
                                   np.array([r[1:] for r in out_j[fr]]),
                                   rtol=RTOL, atol=1e-3)


def test_runner_engines_and_own_area_options():
    dets, feats = _sequence(1)
    with pytest.raises(ValueError, match="engine='step'"):
        pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                        own_area_use=0.3)
    # host shares from the f64 clipping oracle: the step engine gives the
    # JAX runner's ids, and the fused engine takes the same shares
    kw = dict(capacity=16, own_area_use=0.3, own_area_collect=0.5,
              own_area_backend="host", feature_precision="f32")
    out_j, _ = jmot.run_sequence_device_visual(dets, feats, engine="xla",
                                               **kw)
    host_step, _ = pmot.run_sequence_device_visual(
        dets, feats, device="cpu", engine="step", **kw)
    host_fused, _ = pmot.run_sequence_device_visual(dets, feats,
                                                    device="cpu", **kw)
    for fr in out_j:
        ids = [r[0] for r in out_j[fr]]
        assert [r[0] for r in host_step[fr]] == ids, fr
        assert [r[0] for r in host_fused[fr]] == ids, fr
    with pytest.raises(ValueError, match="engine"):
        pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                        engine="xla")
    fused, _ = pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                               capacity=16,
                                               feature_precision="f32")
    step, _ = pmot.run_sequence_device_visual(dets, feats, device="cpu",
                                              capacity=16, engine="step",
                                              feature_precision="f32")
    for fr in fused:
        assert [r[0] for r in step[fr]] == [r[0] for r in fused[fr]], fr
