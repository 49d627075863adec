"""Generic feature-similarity tracking: re-identify objects by embeddings
(the JAX package's `examples/feature_tracker.py`).

No boxes, no Kalman: each object is a drifting feature vector, matched to
its track by euclidean distance over a 3-observation gallery with TopN
voting.  `FeatureTracker` runs on the host; `--device` is taken as by
every example.
"""

import numpy as np

from similari_tpu_torch import FeatureTracker
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    rng = np.random.default_rng(7)
    n, dim = 16, 128
    tracker = FeatureTracker(dim, gallery=3, max_distance=100.0)

    # 16 objects with well-separated identities, drifting a little an epoch
    base = rng.normal(scale=200.0, size=(n, dim)).astype(np.float32)
    first = None
    for epoch in range(12):
        base += rng.normal(scale=0.5, size=base.shape).astype(np.float32)
        ids = tracker.predict(base)
        if first is None:
            first = ids.copy()
        assert (ids == first).all(), "identity lost"
    print(f"{n} identities stable over 12 epochs: ids {ids[:8]} ...")

    # a new object appears -> new track id; an old one keeps its id
    extended = np.concatenate(
        [base, rng.normal(scale=200.0, size=(1, dim)).astype(np.float32)]
    )
    ids2 = tracker.predict(extended)
    assert (ids2[:n] == first).all() and ids2[n] == n + 1
    print(f"new object joined as track {ids2[n]}; gallery of track 1:",
          tracker.gallery_of(1).shape)


if __name__ == "__main__":
    main()
