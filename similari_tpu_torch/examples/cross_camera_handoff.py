"""Multi-camera identity stitching across scene shards (the JAX package's
`examples/cross_camera_handoff.py`).

Each rank of a `torch.distributed` group holds two cameras (scenes):

  1. each camera tracks locally on its rank, with no cross-rank traffic
     in the per-frame step;
  2. when a camera starts a fresh track, a `global_gallery_query` (one
     all_gather, a two-level top-k) asks every rank "have you seen this
     appearance?";
  3. on a hit, `track_merge` stitches the new track into the global
     identity: the gallery rides one all-reduce to the owner, qualities
     pick the surviving top-K features, and the duplicate slot is freed.

The ranks are spawned processes: 4 gloo ranks under `--device cpu`,
min(4, cards) NCCL ranks, one per card, otherwise.  Rank 0 prints.
"""

import numpy as np
import torch

from similari_tpu_torch.bench_pod import run_ranks
from similari_tpu_torch.examples import example_device
from similari_tpu_torch.parallel import (
    global_gallery_query,
    new_batched_visual_state,
    shard_batched_state,
    sharded_visual_step,
    track_merge,
)
from similari_tpu_torch.parallel.mesh import all_gather, all_reduce_sum
from similari_tpu_torch.trackers.visual_step import VisualConfig


def handoff_rank(mesh, _spec):
    """The demo on this rank's two cameras; returns the lines to print."""
    n_dev = mesh.size
    n_scenes = 2 * n_dev  # two cameras per shard
    per_shard = n_scenes // n_dev
    d, t, k, f = 4, 16, 3, 64
    dev = mesh.device

    cfg = VisualConfig(
        positional_kind="iou",
        visual_kind="cosine",
        visual_threshold=0.3,
        visual_minimal_track_length=1,
        max_idle_epochs=10,
        assignment="auction",
    )
    step = sharded_visual_step(cfg, mesh)
    state = shard_batched_state(
        new_batched_visual_state(n_scenes, t, 2, k, f, device="cpu"), mesh)

    rng = np.random.default_rng(0)
    signature = rng.normal(size=(f,)).astype(np.float32)  # the person's ReID

    def block(a):
        lo = mesh.shard * per_shard
        return torch.as_tensor(a[lo:lo + per_shard], device=dev)

    def frame(scene_of_person, epoch, jitter):
        box = np.zeros((n_scenes, d, 5), np.float32)
        feat = np.zeros((n_scenes, d, f), np.float32)
        valid = np.zeros((n_scenes, d), bool)
        box[scene_of_person, 0] = (100 + 3 * epoch + jitter, 80, 0, 0.5, 30)
        feat[scene_of_person, 0] = signature + rng.normal(size=f) * 0.01
        valid[scene_of_person, 0] = True
        ones = np.ones((n_scenes, d), np.float32)
        return (block(box), block(ones), block(valid), block(feat),
                block(valid), block(ones), block(ones),
                block(np.full((n_scenes,), epoch, np.int32)))

    def owned(scene, value):
        """`value` of a global scene, read on every rank."""
        mine = scene // per_shard == mesh.shard
        return int(all_reduce_sum(mesh, torch.tensor(
            int(value(scene % per_shard)) if mine else 0, dtype=torch.int32,
            device=dev)))

    lines = []
    # --- the person walks through camera 0 for three frames --------------
    for e in range(1, 4):
        state, out, _ = step(state, *frame(0, e, 0.0))
    cam0_id = owned(0, lambda s: out.track_id[s, 0])
    lines.append(f"camera 0 tracked the person as id {cam0_id}")

    # --- they appear in the LAST camera (another shard) -------------------
    last = n_scenes - 1
    state, out, _ = step(state, *frame(last, 4, 0.0))
    cam1_id = owned(last, lambda s: out.track_id[s, 0])
    lines.append(f"camera {last} opened a fresh track id {cam1_id}")

    # --- global appearance query: who is this, anywhere? -----------------
    # hits are per gallery FEATURE, so ask for a few and dedupe by track
    qfn = global_gallery_query("cosine", k=4, mesh=mesh)
    q = torch.as_tensor(signature[None], device=dev)
    scores, shard, scene, tids = (x.cpu() for x in qfn(state, q))
    hits = []
    for i in range(4):
        gscene = int(shard[0, i]) * per_shard + int(scene[0, i])
        h = (float(scores[0, i]), gscene, int(tids[0, i]))
        if not any(x[1:] == h[1:] for x in hits):
            hits.append(h)
    lines.append(f"global gallery hits (score, scene, id): {hits}")
    src = next(h for h in hits if h[1] == last)  # the duplicate
    dst = next(h for h in hits if h[1] == 0)  # the original identity

    # --- stitch: merge the duplicate into the original -------------------
    merge = track_merge(mesh)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    state, ok = merge(state, i32([src[1]]), i32([src[2]]), i32([dst[1]]),
                      i32([dst[2]]))
    assert bool(ok.cpu()[0])
    active = all_gather(mesh, state.active).reshape(n_scenes, t).cpu()
    assert active[0].sum() == 1 and active[last].sum() == 0
    collected = int(all_gather(mesh, state.collected).reshape(
        n_scenes, t)[0].max())
    lines.append(
        f"merged camera-{last} id {src[2]} into camera-0 id {dst[2]}; "
        f"unified gallery holds {collected} collected features")
    return lines


def main(argv=None):
    dev = example_device(argv, __doc__)
    ranks = 4 if dev.type == "cpu" else min(4, torch.cuda.device_count())
    # the ranks find the target by its module's name, also when this file
    # runs as __main__
    from similari_tpu_torch.examples.cross_camera_handoff import (
        handoff_rank as target)

    for line in run_ranks(ranks, dev.type, None, target)[0]:
        print(line)


if __name__ == "__main__":
    main()
