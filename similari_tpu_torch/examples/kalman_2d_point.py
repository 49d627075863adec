"""2D point Kalman filter: smoothing a noisy circular trajectory (the JAX
package's `examples/kalman_2d_point.py`).

A point moves on a circle with noisy measurements; after a few updates
the filtered estimate tracks the true path with less error than the raw
measurements.  The filter API runs on the host; `--device` is taken as
by every example.
"""

import math

import numpy as np

from similari_tpu_torch import Point2DKalmanFilter
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    rng = np.random.default_rng(42)
    f = Point2DKalmanFilter()

    radius, noise = 80.0, 4.0

    def true(k):
        return radius * math.cos(0.03 * k), radius * math.sin(0.03 * k)

    state = f.initiate(*true(0))
    err_raw = err_kf = 0.0
    for k in range(1, 40):
        tx, ty = true(k)
        mx = tx + float(rng.normal(scale=noise))
        my = ty + float(rng.normal(scale=noise))
        state = f.predict(state)
        state = f.update(state, mx, my)
        err_raw += math.hypot(mx - tx, my - ty)
        err_kf += math.hypot(state.x() - tx, state.y() - ty)
        if k % 10 == 0:
            print(
                f"k={k:2d} true=({tx:6.2f},{ty:6.2f}) "
                f"meas=({mx:6.2f},{my:6.2f}) "
                f"kf=({state.x():6.2f},{state.y():6.2f})"
            )

    print(f"mean |error|: raw measurements {err_raw / 39:.3f}, "
          f"filtered {err_kf / 39:.3f}")
    assert err_kf < err_raw  # the filter must beat the raw measurements


if __name__ == "__main__":
    main()
