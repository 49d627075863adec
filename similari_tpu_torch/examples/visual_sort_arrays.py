"""VisualSORT's array path (the JAX package's
`examples/visual_sort_arrays.py`), on `--device`.

Per-call tracking without Python objects: detections, confidences, ReID
features and qualities go in as arrays; (ids, boxes, voting types) come
out as arrays.  `predict(observation_set)` remains for the reference's
API.
"""

import numpy as np

from similari_tpu_torch import (
    PositionalMetricType,
    VisualSort,
    VisualSortMetricType,
    VisualSortOptions,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    rng = np.random.default_rng(0)
    n = 6
    opts = (
        VisualSortOptions()
        .visual_metric(VisualSortMetricType.euclidean(10.0))
        .positional_metric(PositionalMetricType.iou(0.3))
        .visual_minimal_track_length(2)
        .max_idle_epochs(5)
    )
    tracker = VisualSort(1, opts, device=dev)

    identities = rng.normal(size=(n, 128)).astype(np.float32)
    xy = rng.uniform(0, 500, (n, 2)).astype(np.float32)

    for frame in range(5):
        xy += rng.uniform(-2, 2, xy.shape).astype(np.float32)
        boxes = np.zeros((n, 5), np.float32)  # (xc, yc, angle, aspect, h)
        boxes[:, :2] = xy
        boxes[:, 3] = 0.5
        boxes[:, 4] = 40.0
        feats = identities + 0.05 * rng.normal(size=(n, 128)).astype(
            np.float32)
        epoch, ids, pred, length, slot, vt = tracker.predict_arrays(
            0, boxes, np.ones((n,), np.float32), feats,
            np.ones((n,), bool), np.full((n,), 0.9, np.float32),
            customs=list(range(n)),
        )
        kinds = ["Visual" if v == 0 else "Positional" for v in vt]
        print(f"epoch {epoch}: ids={ids.tolist()} voting={kinds}")


if __name__ == "__main__":
    main()
