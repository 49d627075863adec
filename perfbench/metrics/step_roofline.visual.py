"""`step_roofline` in the VisualSORT stream cells (`perfbench/readers.py::step_roofline`)."""

from perfbench.readers import step_roofline as read  # noqa: F401
