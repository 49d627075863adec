"""Vectorized keypoint Kalman filter (the JAX package's
`examples/kalman_2d_vec.py`).  The filter API runs on the host;
`--device` is taken as by every example."""

from similari_tpu_torch import Vec2DKalmanFilter
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    f = Vec2DKalmanFilter()
    states = f.initiate([(0.0, 0.0), (10.0, 10.0), (20.0, 5.0)])
    for i in range(1, 4):
        states = f.predict(states)
        pts = [(0.5 * i, 0.3 * i), (10.0 + i, 10.0), (20.0, 5.0 + 0.5 * i)]
        states = f.update(states, pts)
        print([(s.x(), s.y()) for s in states])


if __name__ == "__main__":
    main()
