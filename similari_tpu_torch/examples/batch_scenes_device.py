"""Many scenes tracked in one batched step on the card: 64 scenes stepped
together by `parallel/mesh.py::batched_sort_scan`, each frame one step
over every scene (the JAX package's `examples/batch_scenes_device.py`)."""

import numpy as np
import torch

from similari_tpu_torch.examples import example_device, fast
from similari_tpu_torch.parallel import batched_sort_scan, new_batched_state
from similari_tpu_torch.trackers.sort_step import SortConfig


def main(argv=None):
    dev = example_device(argv, __doc__)
    if fast():  # the smoke size
        scenes, objects, frames = 8, 16, 8
    else:
        scenes, objects, frames = 64, 50, 32
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5)
    scan = batched_sort_scan(cfg)

    rng = np.random.default_rng(0)
    box = np.zeros((frames, scenes, objects, 5), np.float32)
    xy = rng.uniform(0, 1000, size=(scenes, objects, 2))
    for f in range(frames):
        xy += rng.uniform(-2, 2, size=xy.shape)
        box[f, ..., 0] = xy[..., 0]
        box[f, ..., 1] = xy[..., 1]
        box[f, ..., 3] = 0.5
        box[f, ..., 4] = 30.0

    states = new_batched_state(scenes, 2 * objects, 1, device=dev)
    states, (ids, _ovf) = scan(
        states,
        torch.as_tensor(box, device=dev),
        torch.ones((frames, scenes, objects), device=dev),
        torch.ones((frames, scenes, objects), dtype=torch.bool, device=dev),
        torch.ones((scenes,), dtype=torch.int32, device=dev),
    )
    ids = ids.cpu().numpy()
    print("tracked", scenes, "scenes x", frames, "frames;")
    print("scene 0 frame 0 ids:", ids[0, 0][:8])
    print("scene 0 frame -1 ids:", ids[-1, 0][:8], "(stable)")


if __name__ == "__main__":
    main()
