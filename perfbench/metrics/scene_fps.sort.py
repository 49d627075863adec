"""`scene_fps` in the SORT stream cells (`perfbench/readers.py::scene_fps`)."""

from perfbench.readers import scene_fps as read  # noqa: F401
