"""Figure-generation CLI (counterpart of the JAX package's
``entry/plotting.py``; reference: src/plotting.py, but CSV-driven). Host
only: it reads the CSVs the run_* entries write and draws with matplotlib
(without it, no figure is written and the run says so in no line, as the
JAX entry).

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.entry.plotting --config configs/plotting.yaml
"""
from __future__ import annotations

from ..reporting.plotting import generate_all
from ..utils.config import apply_overrides, load_yaml
from . import common


def main():
    p = common.make_parser("CSV-driven paper figures")
    args = p.parse_args()
    cfg = load_yaml(args.config or "configs/plotting.yaml")
    apply_overrides(cfg, args.overrides)
    generate_all(cfg)


if __name__ == "__main__":
    main()
