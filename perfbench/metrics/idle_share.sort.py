"""The device's idle share in the SORT stream cells (`perfbench/readers.py::idle_share`)."""

from perfbench.readers import idle_share as read  # noqa: F401
