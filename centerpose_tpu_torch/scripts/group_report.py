"""Aggregate per-shard raw evaluation stats into one confidence-ranked report,
the twin of the JAX package's `scripts/group_report.py`.

    python -m centerpose_tpu_torch.scripts.group_report --stats 'reports/*_stats.json' --c shoe

Parity target: src/tools/objectron_eval/group_report_new.py. Per-video
evaluator shards dump raw (hit, confidence) records
(`evaluation/evaluator.py::Evaluator.save_stats`, `evaluate.py
--stats_file`); this script merges them (`Evaluator.load_and_merge`) and
computes AP over the union (confidence ranking must happen over the union,
not per shard), printing `Evaluator.report()` and writing it to
`--report_file`.
"""

from __future__ import annotations

import argparse
import glob

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.evaluation.evaluator import Evaluator


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="merge evaluator shard stats into one report")
    p.add_argument("--stats", required=True, help="glob of shard stats json files")
    p.add_argument("--c", dest="category", default="shoe")
    p.add_argument("--report_file", default="")
    args = p.parse_args(argv)

    ev = Evaluator(preset("centerpose", category=args.category))
    files = sorted(glob.glob(args.stats))
    if not files:
        raise SystemExit(f"no stats files match {args.stats}")
    for f in files:
        ev.load_and_merge(f)
    report = ev.report()
    print(report)
    if args.report_file:
        with open(args.report_file, "w") as fh:
            fh.write(report + "\n")
    return report


if __name__ == "__main__":
    main()
