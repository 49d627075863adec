"""PyTorch/CUDA port of similari_tpu for NVIDIA Hopper (H100).

The JAX package `similari_tpu` is the reference this package is held
against; nothing here imports it or JAX.  Entry points run on the card
(`device=None` means CUDA) and raise when CUDA is missing; the CPU is used
only when the caller passes `device="cpu"`.

Ported so far: the fused SORT and VisualSORT sequence pipelines
(`ops/fused_sort.py`, `ops/fused_visual.py`, `eval/mot.py`); the general
SORT step (`trackers/sort_step.py`: oriented boxes, Mahalanobis matching,
constraints, deeper histories) with its geometry, assignment, merges and
constraints; and block-skip NMS (`ops/nms.py`).  The kernels are
hand-written CUDA C++ for `sm_90a` under `csrc/`: the two fused frame
kernels and the rotated-box clip (`ops/clip.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
