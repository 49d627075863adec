"""Polygon clipping (the JAX package's `examples/clipping_intersection.py`).
The f64 clipping runs on the host; `--device` is taken as by every
example."""

from similari_tpu_torch import (BoundingBox, intersection_area,
                                sutherland_hodgman_clip)
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    bbox1 = BoundingBox(0.0, 0.0, 5.0, 10.0).as_xyaah()
    bbox2 = BoundingBox(0.0, 0.0, 10.0, 5.0).as_xyaah()
    clip = sutherland_hodgman_clip(bbox1, bbox2)
    print(clip)
    print("Intersection area:", intersection_area(bbox1, bbox2))

    bbox2 = BoundingBox(0.0, 0.0, 5.0, 10.0).as_xyaah()
    bbox2.rotate(0.5)
    clip = sutherland_hodgman_clip(bbox1, bbox2)
    print(clip)
    print("Intersection area:", intersection_area(bbox1, bbox2))


if __name__ == "__main__":
    main()
