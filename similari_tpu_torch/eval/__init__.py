"""MOT sequence IO, whole-sequence runners, CLEAR / Identity metrics and
synthetic sequences (mirrors `similari_tpu/eval/__init__.py`)."""

from .metrics import clear_metrics, identity_metrics, iou_matrix_ltwh  # noqa: F401
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
from .synthetic import (  # noqa: F401
    generate_adversarial_sequence,
    generate_reid_adversarial_sequence,
    generate_sequence,
)
from ..native import load_sequence_soa  # noqa: F401  (C++ MOT csv loader)
