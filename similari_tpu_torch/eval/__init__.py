"""MOT sequence IO and whole-sequence runners (mirrors
`similari_tpu/eval/__init__.py`; its `metrics` and `synthetic` modules are
not ported yet)."""

from ..native import load_sequence_soa  # noqa: F401  (C++ MOT csv loader)
from .mot import (  # noqa: F401
    ltwh_to_vec5,
    read_detections,
    read_gt,
    run_sequence_device,
    run_sequence_device_visual,
    run_sequence_interactive,
    run_sequence_interactive_visual,
    vec5_to_ltwh,
    write_csv,
)
