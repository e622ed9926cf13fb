"""What every driver shares: the cell a run measures, found by name, and the
record a driver hands back.

A cell is an entry of `workloads` in `BENCHMARK.json`; its configuration is
`posebench/configs/<config>.json`, its traffic `posebench/traffic/
<traffic>.json`, whose `driver` names `posebench/drivers/<driver>.py`, and
each per-layer metric `<name>` is read by `posebench/metrics/<name>.py`.
Adding a cell, a configuration, a traffic mix, a driver or a metric adds
files and entries; it edits none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "posebench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One run's cell: its workload entry, configuration and traffic, the
    seed, the window and the device. `traffic` and `config` are plain dicts
    read from their files (tests shrink them)."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"
    fault: Optional[str] = None      # tests only: a fault planted under the timed path

    @property
    def name(self) -> str:
        return self.workload["name"]


def cell(name: str, seed: int, seconds: float, trace: bool, device="cuda") -> Cell:
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(workload=entry,
                config=load_json(BENCH / "configs" / f"{entry['config']}.json"),
                traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device)


@dataclasses.dataclass
class Result:
    """What a driver measured. `end_to_end`: metric name -> value of the
    untraced window. `counters`: what per-layer readers read (the window's
    program spans and counts, the work counted from shapes). `trace`: the
    profiled segment (`trace.Trace`) of a `--trace 1` run. `checks`: the
    numbers compared and their limits (`checks.judge`); `numbers`: all
    that the comparison worked out, the limited ones and those that say
    where a gap comes from."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    counters: Dict[str, Any]
    checks: List[dict]
    memory_peak_bytes: int
    trace: Any = None
    numbers: Optional[dict] = None   # every number the comparison worked out, limited or not

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks) and self.failed == 0


def driver(name: str):
    return importlib.import_module(f"posebench.drivers.{name}")


def metric_reader(name: str):
    """`posebench/metrics/<name>.py` (a metric's name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"posebench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the block (the reference's float32), restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]
