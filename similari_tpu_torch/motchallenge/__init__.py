"""The MOTChallenge eval kit (mirrors `similari_tpu/motchallenge/`)."""

from .trackers import SimilariTPUSort, SimilariTPUVisualSort, Tracker  # noqa: F401
from .evaluator import evaluate_sequences, run_and_evaluate  # noqa: F401
from .config import (  # noqa: F401
    EvaluatorConfig,
    KitConfig,
    TrackerConfig,
    load_config,
    run_config,
    run_from_config,
)
