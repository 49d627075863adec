"""BatchVisualSort: multi-scene VisualSORT through the batch request API
(the JAX package's `examples/batch_visual_sort.py`).

One `VisualSortPredictionBatchRequest` carries observations for several
scenes; results arrive per scene through the `PredictionBatchResult`
channel.  The scenes run as one batched step on the device.
"""

import numpy as np

from similari_tpu_torch import (
    BatchVisualSort,
    BoundingBox,
    PositionalMetricType,
    VisualSortMetricType,
    VisualSortObservation,
    VisualSortOptions,
    VisualSortPredictionBatchRequest,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    opts = VisualSortOptions()
    opts.visual_metric(VisualSortMetricType.euclidean(5.0))
    opts.positional_metric(PositionalMetricType.iou(0.3))
    opts.visual_minimal_track_length(2)
    opts.max_idle_epochs(4)
    tracker = BatchVisualSort(distance_shards=1, voting_shards=1, opts=opts,
                              device=dev)

    rng = np.random.default_rng(1)
    idents = {scene: rng.normal(size=(2, 32)).astype(np.float32)
              for scene in (101, 202)}

    stable = {}
    for frame in range(5):
        req = VisualSortPredictionBatchRequest()
        for scene, ident in idents.items():
            for i in range(2):
                feat = ident[i] + 0.05 * rng.normal(size=32).astype(
                    np.float32)
                req.add(scene, VisualSortObservation(
                    feature=feat,
                    feature_quality=0.9,
                    bounding_box=BoundingBox(
                        40.0 + 60.0 * i + 2.0 * frame, 30.0, 14.0, 28.0
                    ).as_xyaah(),
                    custom_object_id=i,
                ))
        result = tracker.predict(req)
        for _ in range(result.batch_size()):
            scene, tracks = result.get()
            ids = sorted(t.id for t in tracks)
            stable.setdefault(scene, ids)
            assert stable[scene] == ids, (scene, ids, stable[scene])

    print("stable per-scene ids over 5 frames:", stable)
    assert len(stable) == 2
    assert not (set(stable[101]) & set(stable[202]))  # scenes share no ids


if __name__ == "__main__":
    main()
