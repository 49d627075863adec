"""SORT built from the generic engine's middleware pieces (the JAX
package's `examples/middleware_sort_tracker.py`): the core `TrackStore`
(its feature index on `--device`), the BBox / IoU fixtures and
`SortVoting` used directly rather than the SORT tracker; the
extensibility path for custom trackers."""

from similari_tpu_torch.core import (NoopNotifier, ObservationBuilder,
                                     TrackStoreBuilder)
from similari_tpu_torch.core.examples import (
    BBoxAttributes,
    BBoxAttributesUpdate,
    IOUMetric,
)
from similari_tpu_torch.core.voting import SortVoting
from similari_tpu_torch.examples import example_device
from similari_tpu_torch.utils.bbox import BoundingBox


def main(argv=None):
    dev = example_device(argv, __doc__)
    store = (
        TrackStoreBuilder(1, device=dev)
        .default_attributes(BBoxAttributes())
        .metric(IOUMetric(history=3))
        .notifier(NoopNotifier())
        .build()
    )
    next_id = 0

    def step(detections):
        nonlocal next_id
        candidates = []
        for bb in detections:
            next_id_candidate = 1_000_000 + len(candidates)
            t = (
                store.new_track(next_id_candidate)
                .observation(
                    ObservationBuilder(0)
                    .observation_attributes(bb)
                    .track_attributes_update(BBoxAttributesUpdate())
                    .build()
                )
                .build()
            )
            candidates.append(t)
        dists, _ = store.foreign_track_distances(candidates, 0, False)
        voting = SortVoting(0.3, len(candidates), len(store.tracks))
        winners = voting.winners(dists)
        out = []
        for t in candidates:
            winner = winners.get(t.track_id, [t.track_id])[0]
            if winner == t.track_id:
                next_id += 1
                t.set_track_id(next_id)
                store.add_track(t)
                out.append(next_id)
            else:
                store.merge_external(winner, t, [0], False)
                out.append(winner)
        return out

    for frame in range(4):
        dets = [
            BoundingBox(10.0 + frame * 0.5, 10.0, 8.0, 16.0),
            BoundingBox(100.0 - frame * 0.5, 10.0, 8.0, 16.0),
        ]
        print(f"frame {frame}: track ids {step(dets)}")


if __name__ == "__main__":
    main()
