"""CLI: `python -m similari_tpu_torch.motchallenge <config.yml>`.

As the reference kit's `python/motchallenge/__main__.py:17-84`: run the
configured tracker over every sequence under data_path, write MOT-format
results + processing_stats.csv, print CLEAR + Identity metrics per
sequence on stderr and one JSON line {name: {sequence: metrics}} on
stdout.
"""

import json
import sys

from .config import load_config, run_config


def main():
    if len(sys.argv) != 2:
        print("usage: python -m similari_tpu_torch.motchallenge <config.yml>",
              file=sys.stderr)
        return 2
    cfg = load_config(sys.argv[1])
    print(f"config: {cfg}", file=sys.stderr)
    results = run_config(cfg)
    for seq, metrics in results.items():
        print(f"{seq}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        ), file=sys.stderr)
    print(json.dumps({cfg.name: results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
