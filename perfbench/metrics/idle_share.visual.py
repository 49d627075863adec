"""The device's idle share in the VisualSORT stream cells (`perfbench/readers.py::idle_share`)."""

from perfbench.readers import idle_share as read  # noqa: F401
