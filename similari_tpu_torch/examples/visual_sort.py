"""VisualSORT API walkthrough: two crossing objects tracked by ReID
features (the JAX package's `examples/visual_sort.py`), on `--device`.

Two objects whose boxes cross paths: positional matching alone would swap
their ids at the crossing; their ReID features keep the identities
straight (`voting_type` shows which stage decided each frame).
"""

import numpy as np

from similari_tpu_torch import (
    BoundingBox,
    PositionalMetricType,
    SpatioTemporalConstraints,
    VisualSort,
    VisualSortMetricType,
    VisualSortObservation,
    VisualSortObservationSet,
    VisualSortOptions,
)
from similari_tpu_torch.examples import example_device


def build_tracker(dev) -> VisualSort:
    constraints = SpatioTemporalConstraints()
    constraints.add_constraints([(1, 2.0)])

    opts = VisualSortOptions()
    opts.spatio_temporal_constraints(constraints)
    opts.max_idle_epochs(5)
    opts.kept_history_length(16)
    opts.visual_metric(VisualSortMetricType.cosine(0.25))
    opts.positional_metric(PositionalMetricType.iou(0.3))
    opts.visual_minimal_track_length(2)
    opts.visual_max_observations(4)
    opts.visual_min_votes(1)
    return VisualSort(shards=1, opts=opts, device=dev)


def frame_observations(step: int, rng) -> VisualSortObservationSet:
    """Object A moves left->right, object B right->left along y=40; they
    overlap around step 10.  Each keeps a stable ReID identity vector."""
    ident_a = np.array([1.0, 0.0, 0.2, 0.0], np.float32)
    ident_b = np.array([0.0, 1.0, 0.0, 0.2], np.float32)
    xa = 10.0 + 8.0 * step
    xb = 170.0 - 8.0 * step
    obs = VisualSortObservationSet()
    for ident, x, cid in ((ident_a, xa, 1), (ident_b, xb, 2)):
        feat = ident + rng.normal(scale=0.05, size=4).astype(np.float32)
        obs.add(
            VisualSortObservation(
                feature=feat,
                feature_quality=float(rng.uniform(0.7, 1.0)),
                bounding_box=BoundingBox(x, 40.0, 16.0, 32.0).as_xyaah(),
                custom_object_id=cid,
            )
        )
    return obs


def main(argv=None):
    dev = example_device(argv, __doc__)
    rng = np.random.default_rng(0)
    tracker = build_tracker(dev)

    id_by_custom = {}
    for step in range(20):
        tracks = tracker.predict(frame_observations(step, rng))
        for t in tracks:
            id_by_custom.setdefault(t.custom_object_id, t.id)
            status = ("OK " if id_by_custom[t.custom_object_id] == t.id
                      else "SWAP")
            if step in (0, 9, 10, 11, 19):
                print(
                    f"step {step:2d} obj {t.custom_object_id}: track {t.id} "
                    f"({t.voting_type.name.lower():10s}) {status} "
                    f"x={t.predicted_bbox.xc:6.1f}"
                )

    # identities survived the crossing
    assert len({tid for tid in id_by_custom.values()}) == 2
    print("identities preserved through the crossing:", id_by_custom)

    # lifecycle: idle both tracks out and drain them with their histories
    tracker.skip_epochs(10)
    for w in tracker.wasted():
        print(
            f"wasted track {w.id}: {w.length} frames, "
            f"{len(w.observed_features)} stored features"
        )
    tracker.clear_wasted()


if __name__ == "__main__":
    main()
