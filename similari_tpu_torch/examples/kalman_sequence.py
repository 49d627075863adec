"""Bulk Kalman smoothing of a whole track (the JAX package's
`examples/kalman_sequence.py`).

The filter loop (initiate from the first box, then predict + update per
observation) as ONE call of `filter_sequence`, which runs the port's C++
`kf_box_sequence` / `kf_point_sequence` on the host; `--device` is taken
as by every example.
"""

import numpy as np

from similari_tpu_torch.examples import example_device
from similari_tpu_torch.utils.kalman import (
    Universal2DBoxKalmanFilter, Vec2DKalmanFilter,
)


def main(argv=None):
    example_device(argv, __doc__)
    rng = np.random.default_rng(0)
    n = 200
    z = np.zeros((n, 5), np.float32)  # vec5 = (xc, yc, angle, aspect, h)
    z[:, 0] = np.cumsum(rng.normal(1.0, 0.5, n)).astype(np.float32)
    z[:, 1] = np.cumsum(rng.normal(0.5, 0.5, n)).astype(np.float32)
    z[:, 3] = 2.0
    z[:, 4] = 5.0

    kf = Universal2DBoxKalmanFilter()
    means = kf.filter_sequence(z)
    resid = np.abs(means[:, :2] - z[:, :2]).mean()
    print(f"filtered {n} observations; mean |residual| = {resid:.3f} px")
    print("last filtered state:", np.round(means[-1], 3).tolist())

    # keypoint-vector flavor: 17 independent 2D chains (a pose skeleton),
    # all advanced in the same native call
    kp = np.cumsum(rng.normal(0, 1, (n, 17, 2)), axis=0).astype(np.float32)
    kmeans = Vec2DKalmanFilter().filter_sequence(kp)
    kresid = np.abs(kmeans - kp).mean()
    print(f"filtered {n}x17 keypoints; mean |residual| = {kresid:.3f} px")


if __name__ == "__main__":
    main()
