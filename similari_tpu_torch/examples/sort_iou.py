"""SORT with the IoU metric (the JAX package's `examples/sort_iou.py`) on
`--device`."""

from similari_tpu_torch import (
    BoundingBox,
    PositionalMetricType,
    Sort,
    SpatioTemporalConstraints,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    constraints = SpatioTemporalConstraints()
    constraints.add_constraints([(1, 1.0)])
    sort = Sort(
        shards=4,
        bbox_history=10,
        max_idle_epochs=5,
        method=PositionalMetricType.iou(threshold=0.3),
        spatio_temporal_constraints=constraints,
        kalman_position_weight=0.1,
        kalman_velocity_weight=0.1,
        device=dev,
    )

    box = BoundingBox(10.0, 5.0, 7.0, 7.0).as_xyaah()
    tracks = sort.predict([(box, 11111)])
    for t in tracks:
        print(t)
    sort.skip_epochs(10)

    wasted = sort.wasted()
    print(wasted[0])
    sort.clear_wasted()


if __name__ == "__main__":
    main()
