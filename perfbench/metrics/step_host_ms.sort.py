"""`step_host_ms` in the SORT stream cells (`perfbench/readers.py::step_host_ms`)."""

from perfbench.readers import step_host_ms as read  # noqa: F401
