"""The port's MOTChallenge kit against the JAX package's, on the CPU.

On the same MOT-layout directory of synthetic sequences the two kits'
`evaluate_sequences` give equal metrics and write equal result CSVs
(processing_stats.csv equal but for its fps column, a wall-clock rate).
`load_config` raises on the same bad configs, and on `platform: tpu`,
which only the JAX kit takes; the port's platforms are cpu and cuda.  The
CLI, run as a subprocess on `platform: cpu`, prints the JAX CLI's JSON
line.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from similari_tpu import motchallenge as jkit
from similari_tpu_torch import motchallenge as pkit
from similari_tpu_torch.eval import generate_sequence, write_csv

from torch_parity import one_cpu_thread

one_cpu_thread()

ROOT = pathlib.Path(__file__).resolve().parent.parent


def write_mot_dir(root, seeds=(11, 12), n_frames=40):
    """Synthetic sequences in MOT layout: <seq>/det/det.txt, <seq>/gt/gt.txt."""
    for k, seed in enumerate(seeds):
        gt, dets = generate_sequence(n_objects=10, n_frames=n_frames,
                                     seed=seed, p_miss=0.03, fp_per_frame=0.2)
        seq = root / f"SEQ-{k + 1:02d}"
        (seq / "det").mkdir(parents=True)
        (seq / "gt").mkdir(parents=True)
        write_csv(seq / "det" / "det.txt", [
            (f, -1, round(l, 2), round(t, 2), round(w, 2), round(h, 2),
             round(c, 3), -1, -1, -1)
            for f in sorted(dets) for l, t, w, h, c in dets[f]])
        write_csv(seq / "gt" / "gt.txt", [
            (f, tid, round(l, 2), round(t, 2), round(w, 2), round(h, 2),
             1, 1, 1.0)
            for f in sorted(gt) for tid, l, t, w, h in gt[f]])
    return root


@pytest.fixture(scope="module")
def mot_dir(tmp_path_factory):
    return write_mot_dir(tmp_path_factory.mktemp("mot"))


def _stats_without_fps(path):
    return [line.split(",")[:3] for line in path.read_text().splitlines()]


TRACKERS = {
    "sort_iou": ("sort", dict(method="iou")),
    "sort_maha": ("sort", dict(method="maha")),
    "visual_sort": ("visual_sort", dict(method="iou")),
}


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_evaluate_sequences_matches_jax(name, mot_dir, tmp_path):
    kind, params = TRACKERS[name]
    outs = {}
    results = {}
    for tag, kit, extra in (("jax", jkit, {}), ("port", pkit,
                                                dict(platform="cpu"))):
        cfg = kit.KitConfig(name=name, data_path=str(mot_dir),
                            output_path=str(tmp_path / tag),
                            tracker=kit.TrackerConfig(kind, dict(params)),
                            **extra)
        results[tag] = kit.evaluate_sequences(
            cfg.data_path, cfg.make_tracker(),
            output_path=pathlib.Path(cfg.output_path))
        outs[tag] = tmp_path / tag
    assert results["port"] == results["jax"]
    assert set(results["port"]) == {"SEQ-01", "SEQ-02"}
    for seq in ("SEQ-01", "SEQ-02"):
        assert ((outs["port"] / f"{seq}.txt").read_text()
                == (outs["jax"] / f"{seq}.txt").read_text())
    assert (_stats_without_fps(outs["port"] / "processing_stats.csv")
            == _stats_without_fps(outs["jax"] / "processing_stats.csv"))
    if kind == "sort":
        for m in results["port"].values():
            assert m["MOTA"] > 0.8 and m["IDF1"] > 0.75


def test_run_and_evaluate_matches_jax(mot_dir):
    assert (pkit.run_and_evaluate(mot_dir, method="iou", device="cpu")
            == jkit.run_and_evaluate(mot_dir, method="iou"))


BAD_CONFIGS = {
    "missing_data_path": ("name: x\n", "data_path"),
    "unknown_tracker": ("name: x\ndata_path: /tmp\ntracker:\n  type: nope\n",
                        "unknown tracker type"),
    "unknown_key": ("name: x\ndata_path: /tmp\nbogus_key: 1\n",
                    "unknown keys"),
    "not_a_mapping": ("- 1\n- 2\n", "mapping"),
    "bad_platform": ("name: x\ndata_path: /tmp\nplatform: gpu\n", "platform"),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_load_config_rejects_like_jax(case, tmp_path):
    text, match = BAD_CONFIGS[case]
    path = tmp_path / "bad.yml"
    path.write_text(text)
    for kit in (jkit, pkit):
        with pytest.raises(ValueError, match=match):
            kit.load_config(path)


def test_load_config_platforms(tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text("name: x\ndata_path: /tmp\nplatform: tpu\n")
    jkit.load_config(path)  # the JAX kit's own platform
    with pytest.raises(ValueError, match="cpu or cuda"):
        pkit.load_config(path)
    path.write_text("name: x\ndata_path: /tmp\nplatform: cpu\n"
                    "tracker:\n  type: visual_sort\n  params:\n"
                    "    visual_kind: euclidean\n")
    cfg = pkit.load_config(path)
    assert cfg.platform == "cpu" and cfg.tracker.type == "visual_sort"
    if not torch.cuda.is_available():
        # no silent fallback: the default platform is the card
        path.write_text("name: x\ndata_path: /tmp\n")
        with pytest.raises(RuntimeError, match="CUDA"):
            pkit.load_config(path)


def test_cli_prints_the_jax_json(tmp_path):
    data = write_mot_dir(tmp_path / "data", seeds=(4,), n_frames=25)
    lines = {}
    for pkg in ("similari_tpu", "similari_tpu_torch"):
        cfg = tmp_path / f"{pkg}.yml"
        cfg.write_text(
            f"name: syn-sort\ndata_path: {data}\n"
            f"output_path: {tmp_path / pkg}\nplatform: cpu\n"
            "tracker:\n  type: sort\n  params:\n    method: iou\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.motchallenge", str(cfg)],
            capture_output=True, text=True, timeout=240, env=env,
            cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines[pkg] = proc.stdout.strip().splitlines()[-1]
    assert lines["similari_tpu_torch"] == lines["similari_tpu"]
    out = json.loads(lines["similari_tpu_torch"])
    assert out["syn-sort"]["SEQ-01"]["MOTA"] > 0.8
    usage = subprocess.run(
        [sys.executable, "-m", "similari_tpu_torch.motchallenge"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert usage.returncode == 2 and "usage" in usage.stderr
