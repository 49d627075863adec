"""Many scenes per step on one card (see `mesh.py`)."""

from .mesh import (  # noqa: F401
    batched_sort_scan,
    batched_sort_step,
    batched_visual_scan,
    batched_visual_step,
    batched_visual_step_inplace,
    new_batched_state,
    new_batched_visual_state,
)
