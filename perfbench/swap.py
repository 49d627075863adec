"""`swapped`: a module's global names set for the length of a block.

The new cells' drivers subclass `drivers/stream.py`'s `Driver`, which
looks up its generator class (`Scenes`) when it sets up and its reference
module (`chk`) when it checks; they swap those names for the block.  The
swap holds process-wide, so what runs in the block sees it: a script that
runs the check must sit under `if __name__ == "__main__"` (the check
spawns processes that import the main module).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def swapped(module, **names):
    """`module`'s global names set to `names` inside the block."""
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)
