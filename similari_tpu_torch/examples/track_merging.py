"""Multi-camera track merging in the generic store (the JAX package's
`examples/track_merging.py`); the store's feature index on `--device`."""

from similari_tpu_torch.core import (NoopNotifier, ObservationBuilder,
                                     TrackStoreBuilder)
from similari_tpu_torch.core.examples import (
    BBoxAttributes,
    BBoxAttributesUpdate,
    IOUMetric,
)
from similari_tpu_torch.examples import example_device
from similari_tpu_torch.utils.bbox import BoundingBox


def main(argv=None):
    dev = example_device(argv, __doc__)
    store = (
        TrackStoreBuilder(1, device=dev)
        .default_attributes(BBoxAttributes())
        .metric(IOUMetric(history=5))
        .notifier(NoopNotifier())
        .build()
    )

    # two cameras observe the same physical object with overlapping boxes
    for cam_track, offset in ((1, 0.0), (2, 0.4)):
        t = store.new_track(cam_track)
        for step in range(3):
            t = t.observation(
                ObservationBuilder(0)
                .observation_attributes(
                    BoundingBox(10.0 + offset + step, 5.0, 4.0, 8.0)
                )
                .track_attributes_update(BBoxAttributesUpdate())
                .build()
            )
        store.add_track(t.build())

    print("before merge:", store.shard_stats())
    store.merge_owned(1, 2)
    merged = store.get(1)
    print("merged history:", merged.get_merge_history())
    print("merged attrs boxes:", len(merged.get_attributes().bboxes))


if __name__ == "__main__":
    main()
