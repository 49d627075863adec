"""`step_p95_ms` in the VisualSORT stream cells (`perfbench/readers.py::step_p95_ms`)."""

from perfbench.readers import step_p95_ms as read  # noqa: F401
