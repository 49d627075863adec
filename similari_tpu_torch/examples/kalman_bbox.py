"""Kalman box filter (the JAX package's `examples/kalman_bbox.py`).  The
filter API runs on the host; `--device` is taken as by every example."""

from similari_tpu_torch import (BoundingBox, Universal2DBox,
                                Universal2DBoxKalmanFilter)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    f = Universal2DBoxKalmanFilter()
    state = f.initiate(BoundingBox(0.0, 0.0, 5.0, 10.0).as_xyaah())
    for step in range(5):
        state = f.predict(state)
        print("pred", state.universal_bbox())
        meas = Universal2DBox.ltwh(0.2 * (step + 1), 0.3 * (step + 1), 5.0,
                                   10.0)
        state = f.update(state, meas)

    dist = f.distance(state, Universal2DBox.ltwh(1.0, 1.5, 5.0, 10.0))
    print("gating distance", dist, "cost", f.calculate_cost(dist, False))


if __name__ == "__main__":
    main()
