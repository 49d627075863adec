"""The port's multi-rank weak-scaling harness (`similari_tpu_torch/
bench_pod.py`) against the JAX package's `bench_pod.py`, on gloo ranks.

The n = 1 group runs in this process (`scene_mesh(1, device="cpu")`); the
groups of 2 and 4 ranks are spawned by the harness's own `run_ranks`.  At
4 scenes per rank x 8 objects x 8 frames: each rank's ids equal the
single-process batched scans over its block of the global stream, the
all-reduced new-track count equals the sum of those scans' new tracks,
and the global gallery top-k equals one query over every scene.  Then the
harness's JSON keys against the JAX harness's at the same `--devices`
(the JAX harness's timing replaced by constants), `_error` rows and exit
code 1 when a group fails, and no output without CUDA.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_pod as jpod  # noqa: E402  (the JAX package's bench_pod.py)
from similari_tpu_torch import bench_pod as pod  # noqa: E402
from similari_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from similari_tpu_torch.parallel.gallery import global_gallery_query  # noqa: E402
from similari_tpu_torch.trackers.sort_step import SortConfig  # noqa: E402
from similari_tpu_torch.trackers.visual_step import VisualConfig  # noqa: E402

import torch_dist_worker  # noqa: E402
from torch_parity import one_cpu_thread  # noqa: E402

one_cpu_thread()

ROOT = Path(__file__).resolve().parents[1]
SPEC = pod.PodSpec(trackers=("sort", "visual", "gallery"),
                   scenes_per_device=4, objects=8, feat_dim=16, base_len=8,
                   point_reps=1, queries=6, topk=5)
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def groups():
    """{n: every rank's `rank_point` results} for each group size."""
    out = {1: [pod.rank_point(pmesh.scene_mesh(1, device="cpu"), SPEC)]}
    for n in WORLDS[1:]:
        out[n] = pod.run_ranks(n, "cpu", SPEC)
    return out


@pytest.mark.parametrize("steps,n,seed", [(8, 32, 42), (3, 5, 7)])
def test_box_stream_is_the_jax_harness_stream(steps, n, seed):
    np.testing.assert_array_equal(pod.box_stream(steps, n, seed=seed),
                                  jpod.box_stream(steps, n, seed=seed))


def _global_inputs(n):
    """The group's global streams, as the JAX harness builds them."""
    scenes = SPEC.scenes_per_device * n
    box = pod.box_stream(SPEC.base_len, scenes * SPEC.objects).reshape(
        SPEC.base_len, scenes, SPEC.objects, 5)
    feat = np.random.default_rng(0).normal(
        size=(SPEC.base_len, scenes, SPEC.objects, SPEC.feat_dim)
    ).astype(np.float32)
    return box, feat


def _reference(tracker, box, feat):
    """(ids, new tracks) of the single-process batched scan over a block
    of scenes from a fresh state."""
    n_frames, s, d = box.shape[:3]
    box = torch.as_tensor(box)
    ones = torch.ones((n_frames, s, d))
    valid = torch.ones((n_frames, s, d), dtype=torch.bool)
    epochs0 = torch.ones((s,), dtype=torch.int32)
    if tracker == "sort":
        state = pmesh.new_batched_state(s, 2 * SPEC.objects, 1, device="cpu")
        cfg = SortConfig(
            method="iou", assignment="auction", max_idle_epochs=5,
            oriented=False)
        _, (ids, _) = pmesh.batched_sort_scan(cfg)(state, box, ones, valid,
                                                   epochs0)
        step = pmesh.batched_sort_step(cfg)
        args = (box, ones, valid)
    else:
        state = pmesh.new_batched_visual_state(
            s, 2 * SPEC.objects, 1, pod.GALLERY, SPEC.feat_dim,
            feature_dtype=torch.bfloat16, device="cpu")
        cfg = VisualConfig(
            positional_kind="iou", visual_kind="euclidean",
            visual_threshold=100.0, visual_minimal_track_length=3,
            max_idle_epochs=5, assignment="auction", oriented=False,
            feature_precision="bf16")
        feat = torch.as_tensor(feat)
        _, (ids, _, _) = pmesh.batched_visual_scan(cfg)(
            pmesh.map_tensors(torch.clone, state), box, ones, valid, feat,
            valid, ones, ones, epochs0)
        step = pmesh.batched_visual_step(cfg)
        args = (box, ones, valid, feat, valid, ones, ones)
    new = 0
    for i in range(n_frames):
        state, out = step(state, *(a[i] for a in args), epochs0 + i)
        new += int(out.is_new.sum())
    return ids.numpy(), new


@pytest.mark.parametrize("tracker", ["sort", "visual"])
@pytest.mark.parametrize("n", WORLDS)
def test_rank_ids_equal_batched_scan_on_its_block(groups, tracker, n):
    box, feat = _global_inputs(n)
    per = SPEC.scenes_per_device
    total = 0
    for rank, result in enumerate(groups[n]):
        blk = slice(rank * per, (rank + 1) * per)
        ids, new = _reference(tracker, box[:, blk], feat[:, blk])
        got_ids, got_new = result[tracker]["outputs"]
        np.testing.assert_array_equal(got_ids, ids)
        total += new
        assert result[tracker]["units"] == per * n * SPEC.base_len
        assert len(result[tracker]["samples"]) == SPEC.point_reps
    assert total > 0
    for result in groups[n]:  # the count is all-reduced: equal on every rank
        assert int(result[tracker]["outputs"][1]) == total


@pytest.mark.parametrize("n", WORLDS)
def test_global_gallery_equals_one_query_over_every_scene(groups, n):
    spec = pod.PodSpec(**{**SPEC.__dict__, "scenes_per_device":
                          SPEC.scenes_per_device * n})
    one = pmesh.scene_mesh(1, device="cpu")
    state, queries = pod.gallery_state(one, spec)
    queries = queries + np.float32(SPEC.base_len - 1) * np.float32(1e-6)
    scores, _, scene, track = global_gallery_query(
        "cosine", SPEC.topk, one)(state, queries)
    for result in groups[n]:
        g_scores, g_shard, g_scene, g_track = result["gallery"]["outputs"]
        np.testing.assert_array_equal(
            g_shard * SPEC.scenes_per_device + g_scene, scene.numpy())
        np.testing.assert_array_equal(g_track, track.numpy())
        np.testing.assert_allclose(g_scores, scores.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _jax_line(monkeypatch, capsys, argv):
    """The JAX harness's JSON line, its measurements replaced by 1.0."""
    for name in ("measure_sort", "measure_visual", "measure_gallery_query"):
        monkeypatch.setattr(jpod, name, lambda *a, **k: 1.0)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench_pod.py", *argv])
    jpod.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


TINY = ["--scenes-per-device", "2", "--objects", "4", "--feat-dim", "8",
        "--base-len", "2", "--point-reps", "2"]


@pytest.mark.parametrize("tracker", ["both", "gallery"])
def test_json_keys_equal_the_jax_harness(monkeypatch, capsys, tracker):
    argv = ["--devices", "2", "--tracker", tracker, *TINY]
    want = _jax_line(monkeypatch, capsys, argv)
    assert pod.main(["--device", "cpu", *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) | {"device", "launches"}
    assert set(got["rows"]) == set(want["rows"])
    for key in ("metric", "max_devices", "scenes_per_device", "objects"):
        assert got[key] == want[key]
    assert got["device"] == "cpu" and got["platform"] == "cpu"
    assert all(np.isfinite(v).all() and np.all(np.asarray(v) > 0)
               for v in got["rows"].values())
    # the CPU's merge is the plain version: no kernel launch to count
    assert got["launches"] == ({"visual_n1": {"lane_merge": 0},
                                "visual_n2": {"lane_merge": 0}}
                               if tracker == "both" else {})


def test_failed_rank_raises_with_its_exception():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        pod.run_ranks(2, "cpu", None, torch_dist_worker.raise_on_rank_one)


def test_failed_group_gives_error_rows_and_exit_code_one(monkeypatch,
                                                         capsys):
    real = pod.run_ranks

    def fail_at_two(n, device_type, spec, target=pod.rank_point):
        if n == 2:
            return real(n, device_type, spec,
                        torch_dist_worker.raise_on_rank_one)
        return real(n, device_type, spec, target)

    monkeypatch.setattr(pod, "run_ranks", fail_at_two)
    rc = pod.main(["--device", "cpu", "--devices", "2", "--tracker", "sort",
                   *TINY])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert "sort_n2_error" in line["rows"]
    assert "rank 1 of 2 raised" in line["rows"]["sort_n2_error"]
    assert "sort_n1_scene_fps" in line["rows"]
    assert "sort_n2_scene_fps" not in line["rows"]


def test_more_ranks_than_cards_or_no_cuda_raises():
    res = subprocess.run(
        [sys.executable, "-m", "similari_tpu_torch.bench_pod", "--devices",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA is not available" in res.stderr
