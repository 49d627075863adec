"""YAML config for the MOTChallenge eval kit (mirrors
`similari_tpu/motchallenge/config.py`).

As the reference kit's OmegaConf schema (`python/motchallenge/config.py:
102-146`), with plain dataclasses + PyYAML so eval runs are reproducible
from a config file:

```yaml
name: mot17-sort-iou
data_path: /data/MOT17/train
output_path: /tmp/mot17-out
platform: cuda            # cuda | cpu: the trackers' device (default cuda)
tracker:
  type: sort              # sort | visual_sort
  params:
    method: iou           # iou | maha
    iou_threshold: 0.3
    max_idle_epochs: 5
    min_confidence: 0.05
    report_observed: true
evaluator:
  threshold: 0.5
```

`python -m similari_tpu_torch.motchallenge <config.yml>` runs the
evaluation.  PyYAML is imported by `load_config` only: a `KitConfig` built
in code runs without it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, Optional

PLATFORMS = (None, "cpu", "cuda")


@dataclasses.dataclass
class EvaluatorConfig:
    """CLEAR/Identity scoring options (threshold per `evaluator.py:28-36`)."""

    threshold: float = 0.5


@dataclasses.dataclass
class TrackerConfig:
    type: str = "sort"  # "sort" | "visual_sort"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class KitConfig:
    name: str
    data_path: str
    output_path: Optional[str] = None
    # "cuda" | "cpu" | None: the trackers' device (None means CUDA, as
    # every entry point of the port)
    platform: Optional[str] = None
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    evaluator: EvaluatorConfig = dataclasses.field(
        default_factory=EvaluatorConfig
    )

    def make_tracker(self) -> Callable[[], Any]:
        """Tracker factory matching `evaluate_sequences`' interface."""
        from .trackers import SimilariTPUSort, SimilariTPUVisualSort

        cls = {
            "sort": SimilariTPUSort,
            "visual_sort": SimilariTPUVisualSort,
        }.get(self.tracker.type)
        if cls is None:
            raise ValueError(
                f"unknown tracker type {self.tracker.type!r} "
                "(expected 'sort' or 'visual_sort')"
            )
        params = dict(self.tracker.params)
        return lambda: cls(**params, device=self.platform)


def load_config(config_file_path) -> KitConfig:
    """Load + validate a YAML kit config (reference `config.py:125-146`)."""
    import yaml

    with open(config_file_path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{config_file_path}: expected a YAML mapping")
    for key in ("name", "data_path"):
        if key not in raw:
            raise ValueError(f"{config_file_path}: missing required key {key!r}")
    tracker = raw.get("tracker") or {}
    evaluator = raw.get("evaluator") or {}
    unknown = set(raw) - {"name", "data_path", "output_path", "platform",
                          "tracker", "evaluator"}
    if unknown:
        raise ValueError(f"{config_file_path}: unknown keys {sorted(unknown)}")
    platform = raw.get("platform")
    if platform not in PLATFORMS:
        raise ValueError(f"{config_file_path}: platform must be cpu or cuda")
    cfg = KitConfig(
        name=str(raw["name"]),
        data_path=str(raw["data_path"]),
        output_path=(
            str(raw["output_path"]) if raw.get("output_path") else None
        ),
        platform=platform,
        tracker=TrackerConfig(
            type=str(tracker.get("type", "sort")),
            params=dict(tracker.get("params") or {}),
        ),
        evaluator=EvaluatorConfig(
            threshold=float(evaluator.get("threshold", 0.5))
        ),
    )
    # validate tracker type AND params eagerly: construct one tracker (cheap:
    # nothing runs until the first predict) so a typoed param fails at
    # config-load time, not mid-evaluation
    cfg.make_tracker()()
    return cfg


def run_config(cfg: KitConfig) -> Dict[str, Dict[str, float]]:
    """Run the full evaluation a `KitConfig` describes."""
    from .evaluator import evaluate_sequences

    out = Path(cfg.output_path) if cfg.output_path else None
    return evaluate_sequences(
        cfg.data_path,
        cfg.make_tracker(),
        output_path=out,
        threshold=cfg.evaluator.threshold,
    )


def run_from_config(config_file_path) -> Dict[str, Dict[str, float]]:
    """Load a config and run the full evaluation it describes."""
    return run_config(load_config(config_file_path))
