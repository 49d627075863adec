"""Box types (the JAX package's `examples/bb.py`).  The box types run on
the host; `--device` is taken as by every example."""

from similari_tpu_torch import BoundingBox, Universal2DBox
from similari_tpu_torch.examples import example_device


def main(argv=None):
    example_device(argv, __doc__)
    bb = BoundingBox(left=1.0, top=2.0, width=10.0, height=15.0)
    print(bb)
    print(bb.left, bb.top, bb.width, bb.height)

    bb = BoundingBox.new_with_confidence(1.0, 2.0, 10.0, 15.0, 0.95)
    print(bb.as_xyaah())

    ubb = Universal2DBox(xc=3.0, yc=4.0, angle=0.0, aspect=1.5, height=5.0)
    print(ubb)
    ubb = Universal2DBox.new_with_confidence(3.0, 4.0, 0.0, 1.5, 5.0, 0.85)
    ubb.rotate(0.5)
    polygon = ubb.get_vertices()
    print("Points", polygon.get_points())
    print("area", ubb.area(), "radius", ubb.get_radius())


if __name__ == "__main__":
    main()
