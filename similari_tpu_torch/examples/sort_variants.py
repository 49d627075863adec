"""SORT API variants in one tour: Mahalanobis, rotated boxes, scenes, idle
tracks (the JAX package's `examples/sort_variants.py`), on `--device`."""

from similari_tpu_torch import PositionalMetricType, Sort, Universal2DBox
from similari_tpu_torch.examples import example_device


def main(argv=None):
    dev = example_device(argv, __doc__)
    # --- Mahalanobis metric ------------------------------------------------
    t = Sort(shards=1, bbox_history=4, max_idle_epochs=5,
             method=PositionalMetricType.maha(), device=dev)
    for f in range(4):
        tracks = t.predict(
            [(Universal2DBox.new_with_confidence(40 + 2 * f, 30, None, 0.8,
                                                 25, 0.9), 7)]
        )
    print("maha: track", tracks[0].id, "length", tracks[0].length)
    assert tracks[0].length == 4

    # --- rotated boxes (the oriented step) -----------------------------------
    tr = Sort(shards=1, bbox_history=1, max_idle_epochs=5,
              method=PositionalMetricType.iou(0.3), device=dev)
    ids = set()
    for f in range(3):
        tracks = tr.predict(
            [(Universal2DBox.new_with_confidence(100 + f, 50, 0.35 + 0.01 * f,
                                                 1.0, 30, 0.9), None)]
        )
        ids.add(tracks[0].id)
    print("rotated: stable id set", ids)
    assert len(ids) == 1

    # --- scene ids are isolated realms -------------------------------------
    ts = Sort(shards=1, bbox_history=1, max_idle_epochs=5,
              method=PositionalMetricType.iou(0.3), device=dev)
    bb = Universal2DBox.new_with_confidence(10, 10, None, 1.0, 20, 0.9)
    a = ts.predict_with_scene(1, [(bb, None)])[0]
    b = ts.predict_with_scene(2, [(bb, None)])[0]  # same box, other scene
    print(f"scenes: scene1 track {a.id}, scene2 track {b.id}")
    assert a.id != b.id  # never merged across scenes

    # --- idle tracks (observed this epoch vs carried predictions) ----------
    ti = Sort(shards=1, bbox_history=4, max_idle_epochs=5,
              method=PositionalMetricType.iou(0.3), device=dev)
    box = Universal2DBox.new_with_confidence(50, 50, None, 1.0, 30, 0.9)
    ti.predict([(box, 1)])
    ti.skip_epochs(1)  # the track missed an epoch
    idle = ti.idle_tracks()
    print("idle:", [(x.id, x.length) for x in idle])
    assert len(idle) == 1


if __name__ == "__main__":
    main()
