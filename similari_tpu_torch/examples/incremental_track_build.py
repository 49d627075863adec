"""Incremental track building with the generic engine (the JAX package's
`examples/incremental_track_build.py`).  A lone `Track` lives on the
host; `--device` is taken as by every example."""

from similari_tpu_torch.core import NoopNotifier, Track
from similari_tpu_torch.core.examples import (
    FeatGen,
    SimpleAttributeUpdate,
    SimpleAttrs,
    SimpleMetric,
)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    track = Track(SimpleAttrs(), SimpleMetric(), NoopNotifier(), track_id=7)
    gen = FeatGen(1.0, 16, 0.05, seed=0)
    for step in range(5):
        obs = next(gen)
        track.add_observation(
            0, 0.5, obs.feature(),
            SimpleAttributeUpdate() if step == 0 else None,
        )
        print(f"step {step}: observations={len(track.get_observations(0))}")
    print("merge history:", track.get_merge_history())
    print("baked:", track.get_attributes().baked(track.observations))


if __name__ == "__main__":
    main()
