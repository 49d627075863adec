"""Multi-scene BatchSort (the JAX package's `examples/batch_sort.py`)."""

from similari_tpu_torch import (
    BatchSort,
    BoundingBox,
    PositionalMetricType,
    SortPredictionBatchRequest,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    bs = BatchSort(
        distance_shards=2,
        voting_shards=2,
        bbox_history=1,
        max_idle_epochs=5,
        method=PositionalMetricType.maha(),
        device=dev,
    )
    for step in range(3):
        req = SortPredictionBatchRequest()
        for scene in range(4):
            req.add(
                scene,
                BoundingBox(100.0 * scene + step, 10.0, 5.0, 10.0).as_xyaah(),
                scene * 100 + step,
            )
        res = bs.predict(req)
        while res.ready():
            scene_id, tracks = res.get()
            print(step, scene_id, tracks[0].id, tracks[0].custom_object_id)


if __name__ == "__main__":
    main()
