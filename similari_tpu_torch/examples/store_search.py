"""Similarity search over the generic track store (the JAX package's
`examples/store_search.py`).

A store of N feature tracks queried with a fresh candidate.  The record
API (`foreign_track_distances`) streams `ObservationMetricOk` objects;
the arrays API (`foreign_track_distances_arrays`) returns the same query
as one matrix from the store's feature index, one f32 tensor on
`--device`: the search path.
"""

import numpy as np

from similari_tpu_torch.core.examples import (
    BatchedSimpleMetric,
    SimpleAttributeUpdate,
    SimpleAttrs,
)
from similari_tpu_torch.core.store import TrackStoreBuilder
from similari_tpu_torch.core.track import ObservationBuilder
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    rng = np.random.default_rng(0)
    dim, count = 64, 500

    db = (
        TrackStoreBuilder(4, device=dev)
        .default_attributes(SimpleAttrs())
        .metric(BatchedSimpleMetric())  # declares supports_batch_features
        .build()
    )
    for i in range(count):
        db.add(i, 0, 1.0, rng.normal(size=dim).astype(np.float32),
               SimpleAttributeUpdate())

    cand = (
        db.new_track(count + 1)
        .observation(
            ObservationBuilder(0)
            .observation_attributes(1.0)
            .observation(rng.normal(size=dim).astype(np.float32))
            .track_attributes_update(SimpleAttributeUpdate())
            .build()
        )
        .build()
    )

    # record API
    records, errors = db.foreign_track_distances([cand], 0, True)
    print(f"record API: {len(records)} ObservationMetricOk records")

    # arrays API (the search path: one product over the store's index)
    to_id, obs_ix, dist = db.foreign_track_distances_arrays(cand, 0, True)
    k = np.argsort(dist[0])[:5]
    print("top-5 nearest tracks:",
          [(int(to_id[j]), round(float(dist[0, j]), 3)) for j in k])


if __name__ == "__main__":
    main()
