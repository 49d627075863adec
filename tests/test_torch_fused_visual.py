"""The port's fused VisualSORT chunk (plain PyTorch version, on the CPU)
against the JAX package's Pallas kernel in interpret mode.

Ids, slots, voting types, is_new, lengths, overflow flags and next_id must
be equal: they decide track identity.  Boxes and Kalman state are held at
torch_parity.RTOL/ATOL (XLA may contract a multiply-add that PyTorch
rounds twice); gallery lanes and the feature history, which are copies of
input features, at torch_parity.GALLERY_TOL.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similari_tpu.ops.pallas_visual import compiled_pallas_visual_scan
from similari_tpu.trackers.visual_state import new_visual_state as jax_new_state
from similari_tpu.trackers.visual_step import VisualConfig as JaxVisualConfig
from similari_tpu_torch.convert import (visual_state_from_numpy,
                                        visual_state_to_numpy)
from similari_tpu_torch.ops.fused_visual import (_gallery_distances,
                                                 fused_visual_chunk,
                                                 fused_visual_chunk_plain,
                                                 fused_visual_scan,
                                                 state_to_tuple)
from similari_tpu_torch.ops.gallery_dots import (PAD, TILE_COLS, TILE_ROWS,
                                                 gallery_dots,
                                                 gallery_dots_plain,
                                                 needed_columns)
from similari_tpu_torch.trackers.visual_state import new_visual_state
from similari_tpu_torch.trackers.visual_step import (VisualConfig,
                                                     visual_scan, visual_step)

from kernel_replay import stage_bf16, staged_dots_replay
from torch_parity import (ATOL, RTOL, VISUAL_CONFIGS, assert_state_dicts_match,
                          crowded_stream, jax_state_dict, large_norm_stream,
                          one_cpu_thread, visual_overflow_stream,
                          visual_padded_stream, visual_stream)

one_cpu_thread()

CPU = torch.device("cpu")
CHUNK = 4


def _run_both(cfg_kw, stream, t, k, f):
    """Both packages from the same (empty JAX) state, crossing through the
    numpy dict.  Returns (jax state dict, jax outputs, port state dict,
    port outputs) as numpy."""
    st = jax_new_state(t, 1, k, f)
    start = jax_state_dict(st)
    run = compiled_pallas_visual_scan(JaxVisualConfig(**cfg_kw), CHUNK,
                                      interpret=True)
    sj, outs_j = run(st, *(jnp.asarray(x) for x in stream), jnp.int32(1))
    sp, outs_p = fused_visual_scan(
        VisualConfig(**cfg_kw), visual_state_from_numpy(start, CPU),
        *(torch.tensor(x) for x in stream), 1, CHUNK)
    return (jax_state_dict(sj), [np.asarray(x) for x in outs_j],
            visual_state_to_numpy(sp), [x.numpy() for x in outs_p])


@pytest.fixture(scope="module")
def refs():
    """One JAX interpret run per (config, seed), shared by the tests."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


STEPS, D, T, K, F = 8, 8, 32, 3, 16


def _config_run(refs, name, seed, **extra):
    kw = dict(VISUAL_CONFIGS[name], **extra)
    return refs((name, seed, tuple(sorted(extra.items()))), lambda: _run_both(
        kw, visual_stream(seed, STEPS, D, F), T, K, F))


def _assert_outputs_equal(oj, op, float_rows=None):
    """ids, slots, pred, voting type, is_new, length, overflow."""
    for i in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(op[i], oj[i], err_msg=f"output {i}")
    np.testing.assert_allclose(op[2], oj[2], rtol=RTOL, atol=ATOL)


CONFIG_SEEDS = [(n, s) for n in VISUAL_CONFIGS for s in (0, 1)]


@pytest.mark.parametrize("name,seed", CONFIG_SEEDS)
def test_fused_visual_outputs_match_pallas(refs, name, seed):
    _, oj, _, op = _config_run(refs, name, seed)
    assert not oj[6].any()
    _assert_outputs_equal(oj, op)


@pytest.mark.parametrize("name,seed", CONFIG_SEEDS)
def test_fused_visual_state_matches_pallas(refs, name, seed):
    sj, _, sp, _ = _config_run(refs, name, seed)
    assert_state_dicts_match(sj, sp)


def test_fused_visual_bf16_matches_pallas(refs):
    """bf16-rounded gallery inputs with f32 products and sums, norms from
    the f32 values; the state keeps f32 storage."""
    sj, oj, sp, op = _config_run(refs, "euclid_iou", 0,
                                 feature_precision="bf16")
    _assert_outputs_equal(oj, op)
    assert_state_dicts_match(sj, sp)


def test_fused_visual_bf16_storage_matches_pallas():
    """A bf16-stored gallery is rounded at chunk boundaries, as the
    reference's tuple_to_state does."""
    kw = dict(VISUAL_CONFIGS["cosine_gates"], feature_precision="bf16")
    stream = visual_stream(3, STEPS, D, F)
    st = jax_new_state(T, 1, K, F, feature_dtype=jnp.bfloat16)
    run = compiled_pallas_visual_scan(JaxVisualConfig(**kw), CHUNK,
                                      interpret=True)
    sj, oj = run(st, *(jnp.asarray(x) for x in stream), jnp.int32(1))
    sp, op = fused_visual_scan(
        VisualConfig(**kw), new_visual_state(T, 1, K, F, torch.bfloat16, CPU),
        *(torch.tensor(x) for x in stream), 1, CHUNK)
    assert sp.feats.dtype == torch.bfloat16
    _assert_outputs_equal([np.asarray(x) for x in oj], [x.numpy() for x in op])
    assert_state_dicts_match(jax_state_dict(sj), visual_state_to_numpy(sp))


@pytest.mark.parametrize("recycle", [False, True])
def test_fused_visual_overflow_parity(refs, recycle):
    """Capacity 8 < new tracks: the overflowing frame writes nothing while
    next_id advances (with recycling, slots free up every third frame)."""
    kw = dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=2,
              recycle_idle=recycle)
    sj, oj, sp, op = refs(("overflow", recycle), lambda: _run_both(
        kw, visual_overflow_stream(STEPS, D, F), 8, K, F))
    flags = op[6]
    assert flags.any() and not flags[0]
    if recycle:
        assert not flags[3] and not flags[6]
    _assert_outputs_equal(oj, op)
    assert_state_dicts_match(sj, sp)


@pytest.mark.parametrize("recycle", [False, True])
def test_fused_visual_zero_padded_rows(refs, recycle):
    """All-zero padded boxes and features must not NaN the state; their
    rows never write."""
    kw = dict(positional_kind="iou", oriented=False, assignment="auction",
              visual_kind="cosine", visual_threshold=0.5,
              visual_minimal_track_length=1, max_idle_epochs=10,
              feature_precision="bf16", recycle_idle=recycle)
    sj, oj, sp, op = refs(("padded", recycle), lambda: _run_both(
        kw, visual_padded_stream(12, 16, F), 64, K, F))
    assert np.isfinite(sp["pred_box"]).all()
    _assert_outputs_equal(oj, op)
    assert_state_dicts_match(sj, sp)


@pytest.mark.parametrize("name", ["euclid_iou", "maha"])
def test_fused_visual_crowded_auction_matches_pallas(refs, name):
    """Overlapping objects, re-detections (one an exact copy) and features
    too noisy to match: rows fall to the positional auction, which runs
    several rounds per frame, and both packages agree on every id."""
    stream = crowded_stream(0, STEPS, 16, 12, F, 133.0, noise=2.0, copies=1)
    kw = VISUAL_CONFIGS[name]
    sj, oj, sp, op = refs(("crowded", name), lambda: _run_both(
        kw, stream, 64, K, F))
    stats = fused_visual_chunk(
        VisualConfig(**kw),
        state_to_tuple(new_visual_state(64, 1, K, F, device=CPU)),
        *(torch.tensor(x) for x in stream), 1)[8]
    assert stats[:, 0].float().mean() > 2  # the auction contends
    _assert_outputs_equal(oj, op)
    assert_state_dicts_match(sj, sp)


def test_large_norm_euclidean_identities(refs):
    """Identities of norm ~4e5: the gram-form distance has an f32
    cancellation floor of a few hundred units.  With a 1e4 gate the same
    identity still matches and others (~5.7e5 apart) do not, in both
    packages: no phantom tracks, and the ids agree."""
    kw = dict(VISUAL_CONFIGS["euclid_iou"], visual_threshold=1e4,
              visual_minimal_track_length=1)
    sj, oj, sp, op = refs(("large_norm",), lambda: _run_both(
        kw, large_norm_stream(STEPS, D, F), T, K, F))
    _assert_outputs_equal(oj, op)
    assert_state_dicts_match(sj, sp)
    assert int(sp["next_id"]) == D  # one track per object
    assert (op[3][1:] == 0).all()  # every later match is visual


def test_visual_step_and_scan_run_the_kernel_path(refs):
    """`visual_step` and `visual_scan` run the general step, which gives
    the fused kernel's ids, voting types and is_new flags frame by frame
    (f32 features), as the JAX package's two paths do."""
    _, oj, _, _ = _config_run(refs, "euclid_iou", 0)
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    stream = [torch.tensor(x) for x in visual_stream(0, STEPS, D, F)]
    st = new_visual_state(T, 1, K, F, device=CPU)
    for s in range(STEPS):
        st, out = visual_step(cfg, st, *(x[s] for x in stream), 1 + s)
        np.testing.assert_array_equal(out.track_id.numpy(), oj[0][s])
        np.testing.assert_array_equal(out.voting_type.numpy(), oj[3][s])
        np.testing.assert_array_equal(out.is_new.numpy(), oj[4][s] > 0)
        assert out.track_id.shape == (D,) and out.overflow.shape == ()
    st2, outs = visual_scan(cfg, new_visual_state(T, 1, K, F, device=CPU),
                            *stream, 1)
    np.testing.assert_array_equal(outs.track_id.numpy(), oj[0])
    assert_state_dicts_match(visual_state_to_numpy(st),
                             visual_state_to_numpy(st2))


@pytest.mark.parametrize("bad", [
    dict(oriented=True), dict(own_area_use=0.5, own_area_backend="device")])
def test_out_of_scope_configs_raise(bad):
    """The fused scan refuses oriented boxes and device own-area shares,
    naming the general step; `visual_scan` (the general step) runs them."""
    cfg = VisualConfig(**dict(VISUAL_CONFIGS["euclid_iou"], **bad))
    stream = [torch.tensor(x) for x in visual_stream(0, CHUNK, D, F)]
    with pytest.raises(NotImplementedError, match="general step"):
        fused_visual_scan(cfg, new_visual_state(T, 1, K, F, device=CPU),
                          *stream, 1, CHUNK)
    _, out = visual_scan(cfg, new_visual_state(T, 1, K, F, device=CPU),
                         *stream, 1)
    assert out.track_id.shape == (CHUNK, D) and not out.overflow.any()


def test_history_other_than_one_raises():
    """The fused scan keeps history depth 1; `visual_scan` runs depth 2."""
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    stream = [torch.tensor(x) for x in visual_stream(0, CHUNK, D, F)]
    with pytest.raises(NotImplementedError, match="general step"):
        fused_visual_scan(cfg, new_visual_state(T, 2, K, F, device=CPU),
                          *stream, 1, CHUNK)
    st, _ = visual_scan(cfg, new_visual_state(T, 2, K, F, device=CPU),
                        *stream, 1)
    assert st.hist_obs.shape == (T, 2, 5) and st.hist_feat_valid.any()


def test_config_defaults_match_jax():
    """The port's VisualConfig carries the reference's fields and defaults,
    and the same derived thresholds."""
    a = {f.name: f.default for f in dataclasses.fields(JaxVisualConfig)}
    b = {f.name: f.default for f in dataclasses.fields(VisualConfig)}
    assert a == b
    for kind in ("iou", "maha"):
        assert (VisualConfig(positional_kind=kind).new_track_threshold
                == JaxVisualConfig(positional_kind=kind).new_track_threshold)


def _np_bf16(a):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("f", [16, 129])
def test_gallery_dots_plain_matches_numpy(f, bf16):
    """Chunk rows against launch-start lanes and against each other, norms
    of the unrounded rows; the entries the scan reads are the lanes and
    the rows of earlier frames (a block triangle)."""
    rng = np.random.default_rng(f)
    c, d, m = 3, 4, 10
    x = rng.normal(size=(c * d, f)).astype(np.float32)
    g = rng.normal(size=(m, f)).astype(np.float32) * 3.0
    dots, norms = gallery_dots_plain(torch.tensor(x), torch.tensor(g), bf16)
    cols = np.concatenate([g, x]).astype(np.float64)
    rx, rc = (_np_bf16(a).astype(np.float64) if bf16 else a.astype(np.float64)
              for a in (x, cols))
    scale = np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(cols, axis=1)
    err = np.abs(dots.numpy() - rx @ rc.T)
    assert (err <= 1e-5 * scale + 1e-6).all()
    np.testing.assert_allclose(norms.numpy(), (cols * cols).sum(1), rtol=1e-5)
    assert torch.equal(gallery_dots(torch.tensor(x), torch.tensor(g), bf16,
                                    d)[0], dots)
    need = needed_columns(c * d, m, d).numpy()
    frame = np.arange(c * d) // d
    assert need.shape == (c * d, m + c * d) and need[:, :m].all()
    np.testing.assert_array_equal(need[:, m:], frame[:, None] > frame[None])


@pytest.mark.parametrize("f", [3, 16, 129, 512])
def test_gallery_dots_bf16_staging_matches_plain(f):
    """The bf16 kernel's staging pass (each row of [G ; X] rounded to bf16
    once, zero-padded to a multiple of 64 columns) multiplied as the
    product kernel tiles it (TILE_ROWS x TILE_COLS output tiles over the
    padded width, skipped tiles left out) equals `gallery_dots_plain` bit
    for bit on every entry the scan reads.  Ragged: 5 frames of 64 rows
    against 70 lanes; the first tile row's chunk-column tile is
    skipped."""
    rng = np.random.default_rng(f)
    c, d, m = 5, 64, 70
    x = torch.tensor(rng.normal(size=(c * d, f)), dtype=torch.float32)
    g = torch.tensor(3.0 * rng.normal(size=(m, f)), dtype=torch.float32)
    st = stage_bf16(x, g)
    assert st.dtype == torch.bfloat16 and st.shape == (m + c * d,
                                                       -(-f // PAD) * PAD)
    assert torch.equal(st[:, :f].view(torch.int16),
                       torch.cat([g, x]).to(torch.bfloat16).view(torch.int16))
    assert not st[:, f:].any()
    replay = staged_dots_replay(x, g, d)
    plain, _ = gallery_dots_plain(x, g, True)
    need = needed_columns(c * d, m, d)
    assert not replay[need].isnan().any()
    assert torch.equal(replay[need], plain[need])
    # rows of frames 0-2 against chunk columns of frames 2-4
    assert bool(replay[:TILE_ROWS, TILE_COLS:].isnan().all())


def _lane_entered(cfg, st, out, valid, box, fvalid, qual, oa, k):
    """(slot, lane) entered by each detection row of one frame, or None:
    the rule by which `fused_visual_kernel` keeps its lane-source table
    (evict the lowest-quality lane of a full matched track, the lowest
    index first; enter the lowest free lane; a new track's first feature
    skips the collect gate; an overflowing frame enters nothing)."""
    _, slots, _, _, is_new, _, ovf = (x[0] for x in out[:7])
    if bool(ovf):
        return [None] * len(slots)
    gv, gq = st[14] > 0, st[13]
    area_ok = box[:, 3] * box[:, 4] * box[:, 4] >= cfg.visual_minimal_area
    collect = ((fvalid > 0) & (qual >= cfg.visual_minimal_quality_collect)
               & (oa >= cfg.own_area_collect) & area_ok)
    entered = []
    for r, sl in enumerate(slots.tolist()):
        new = bool(is_new[r])
        if not (valid[r] > 0 and fvalid[r] > 0 and (new or collect[r])):
            entered.append(None)
            continue
        live = [False] * k if new else gv[sl].tolist()
        if sum(live) >= k:
            q = gq[sl].tolist()
            live[min(range(k), key=lambda i: (q[i], i))] = False
        entered.append((sl, live.index(False) if False in live else 0))
    return entered


def _replay_with_sources(cfg, stream, t, k, warm, chunk):
    """Frames [warm, warm + chunk) of `stream` as one chunk, replayed one
    frame at a time through `fused_visual_chunk_plain` from the state the
    first `warm` frames leave, with a lane-source table kept by the
    kernel's rule.  Checks at every frame that each valid lane holds the
    value its table entry names, and that the distances gathered from
    `gallery_dots_plain` through the table equal `_gallery_distances`.
    Returns (launch-start-lane reads, in-chunk-row reads, lanes entered
    twice or more)."""
    box, conf, valid, feat, fvalid, qual, oa = (torch.tensor(x)
                                                for x in stream)
    d, f = feat.shape[1:]
    st = state_to_tuple(new_visual_state(t, 1, k, f, device=CPU))
    if warm:
        st = fused_visual_chunk_plain(
            cfg, st, *(x[:warm] for x in (box, conf, valid, feat, fvalid,
                                          qual, oa)), 1)[0]
    m = t * k
    x = feat[warm:warm + chunk].reshape(chunk * d, f)
    cols = torch.cat([st[12].reshape(m, f), x])
    bf16 = cfg.feature_precision == "bf16"
    dots, norms = gallery_dots_plain(x, st[12].reshape(m, f), bf16)
    src = torch.arange(m)
    reads, entered_count = [0, 0], torch.zeros(m, dtype=torch.int64)
    for s in range(chunk):
        e = warm + s
        lanes = st[14].reshape(m) > 0
        assert torch.equal(st[12].reshape(m, f)[lanes], cols[src[lanes]])
        ref = _gallery_distances(cfg, feat[e], st[12])
        for i, (w_ref, _) in enumerate(ref):
            col = src.reshape(t, k)[:, i]
            dot = dots[s * d:(s + 1) * d][:, col]
            qn, gn = norms[m + s * d + torch.arange(d)], norms[col]
            if cfg.visual_kind == "euclidean":
                w = torch.sqrt(torch.clamp(qn[:, None] + gn[None, :]
                                           - 2.0 * dot, min=0.0))
            else:
                den = torch.sqrt(qn)[:, None] * torch.sqrt(gn)[None, :]
                w = 1.0 - dot / torch.where(den > 0, den, 1.0)
            live = st[14][:, i] > 0
            torch.testing.assert_close(w[:, live], w_ref[:, live],
                                       rtol=1e-5, atol=1e-5)
            reads[0] += int((live & (col < m)).sum())
            reads[1] += int((live & (col >= m)).sum())
        frame = [y[e:e + 1] for y in (box, conf, valid, feat, fvalid, qual,
                                      oa)]
        before = st
        st, *out = fused_visual_chunk_plain(cfg, st, *frame, 1 + e)
        for r, lane in enumerate(_lane_entered(
                cfg, before, out, valid[e], box[e], fvalid[e], qual[e], oa[e],
                k)):
            if lane is not None:
                src[lane[0] * k + lane[1]] = m + s * d + r
                entered_count[lane[0] * k + lane[1]] += 1
    lanes = st[14].reshape(m) > 0
    assert torch.equal(st[12].reshape(m, f)[lanes], cols[src[lanes]])
    return reads[0], reads[1], int((entered_count >= 2).sum())


REPLAY_CASES = {
    # (config, stream, T, warm-up frames, chunk)
    "stream": (VISUAL_CONFIGS["euclid_iou"],
               lambda: visual_stream(2, 12, D, F), T, 4, 8),
    "padded": (dict(VISUAL_CONFIGS["cosine_gates"], feature_precision="bf16"),
               lambda: visual_padded_stream(12, 16, F), 64, 4, 8),
    "overflow": (dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=2),
                 lambda: visual_overflow_stream(8, 8, F), 8, 0, 8),
    "overflow_recycle": (dict(VISUAL_CONFIGS["euclid_iou"], max_idle_epochs=2,
                              recycle_idle=True),
                         lambda: visual_overflow_stream(8, 8, F), 8, 0, 8),
    "crowded": (dict(VISUAL_CONFIGS["euclid_iou"], feature_precision="bf16"),
                lambda: crowded_stream(0, 8, 16, 12, F, 133.0, noise=0.3,
                                       copies=1), 64, 2, 6),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_lane_sources_name_every_lane_and_distance(case):
    """The invariant the CUDA design rests on: within a chunk every valid
    lane holds its launch-start value or a chunk row of an earlier frame,
    and a table kept as the kernel keeps it names which, so one product
    computed before the chunk gives every frame's gallery distances."""
    kw, make, t, warm, chunk = REPLAY_CASES[case]
    start, inchunk, twice = _replay_with_sources(
        VisualConfig(**kw), make(), t, 3, warm, chunk)
    if warm:
        assert start > 0
    if case in ("stream", "padded", "crowded"):
        assert inchunk > 0
    if case == "stream":
        assert twice > 0  # a lane evicted and refilled twice in the chunk


def test_phase_stamps_need_the_cuda_kernel():
    """Phase stamps come from the CUDA kernel: CPU inputs refuse them."""
    cfg = VisualConfig(**VISUAL_CONFIGS["euclid_iou"])
    stream = [torch.tensor(x) for x in visual_stream(0, CHUNK, D, F)]
    st = state_to_tuple(new_visual_state(T, 1, K, F, device=CPU))
    with pytest.raises(ValueError, match="prof"):
        fused_visual_chunk(cfg, st, *stream, 1,
                           prof=torch.zeros((CHUNK, 11), dtype=torch.int64))


@pytest.mark.parametrize("x,g,d,err", [
    ((6, 4), (5, 3), 2, ValueError),  # widths differ
    ((6, 4), (5, 4), 4, ValueError),  # rows not whole frames
    ((6, 4), (0, 4), 2, ValueError),  # no lanes
    ((6, 4), (5, 4), 2, TypeError),  # float64
])
def test_gallery_dots_rejects_bad_inputs(x, g, d, err):
    dtype = torch.float64 if err is TypeError else torch.float32
    with pytest.raises(err):
        gallery_dots(torch.zeros(x, dtype=dtype), torch.zeros(g, dtype=dtype),
                     False, d)
