"""The device's idle share in the replay cell
(`perfbench/readers.py::idle_share`)."""

from perfbench.readers import idle_share as read  # noqa: F401
