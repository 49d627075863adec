"""The public API's demonstrations on the port (the JAX package's
`examples/*.py`, one module of the same name each).

Run one as `python -m similari_tpu_torch.examples.<name> [--device cuda|cpu]`:
the card by default (raising without CUDA), the CPU's plain versions
under `--device cpu`.  `SIMILARI_EXAMPLE_FAST=1` shrinks the examples
that have a smaller smoke size, as in the JAX package.  Importing a
module runs nothing."""

from __future__ import annotations

import argparse
import os

import torch

from ..device import resolve_device


def example_device(argv=None, doc: str = "") -> torch.device:
    """The device an example runs on: `--device cuda` (the default; raises
    without CUDA) or `--device cpu`."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    return resolve_device(ap.parse_args(argv).device)


def fast() -> bool:
    """The smoke size (`SIMILARI_EXAMPLE_FAST` set)."""
    return bool(os.environ.get("SIMILARI_EXAMPLE_FAST"))
