"""Generic engine: a store and TopN voting (the JAX package's
`examples/simple.py`); the store's feature index on `--device`."""

from similari_tpu_torch.core import (
    NoopNotifier,
    ObservationBuilder,
    TopNVoting,
    TrackStoreBuilder,
)
from similari_tpu_torch.core.examples import (
    FeatGen,
    SimpleAttributeUpdate,
    SimpleAttrs,
    SimpleMetric,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    store = (
        TrackStoreBuilder(2, device=dev)
        .default_attributes(SimpleAttrs())
        .metric(SimpleMetric())
        .notifier(NoopNotifier())
        .build()
    )
    voting = TopNVoting(topn=1, max_distance=1.0, min_votes=1)

    # populate the store with drifting-feature tracks
    gens = [FeatGen(float(i) * 5.0, 16, 0.1, seed=i) for i in range(5)]
    for tid, gen in enumerate(gens, start=1):
        for j in range(3):
            obs = next(gen)
            store.add(tid, 0, 0.5, obs.feature(),
                      SimpleAttributeUpdate() if j == 0 else None)

    # query with a fresh observation near track 3's feature space
    query = (
        store.new_track(1000)
        .observation(
            ObservationBuilder(0)
            .observation_attributes(0.5)
            .observation(next(gens[2]).feature())
            .track_attributes_update(SimpleAttributeUpdate())
            .build()
        )
        .build()
    )
    dists, errs = store.foreign_track_distances([query], 0, False)
    winners = voting.winners(dists)
    print("winner for query:", winners[1000][0].winner_track)


if __name__ == "__main__":
    main()
