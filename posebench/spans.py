"""What the per-layer readers read of the program's own telemetry: the
registry of `centerpose_tpu_torch/utils/profiler.py` (`snapshot()`), in the
process that ran the cell. Only chunks and train steps that ran outside the
profiler count (warm-up, window and drain); the traced segment runs slower.
A program without that telemetry gives nothing, and its readers `None`.

- `chunks(snap)`: for each served chunk whose `submit` and `finish` spans
  (one chunk id) were both recorded unprofiled, `busy_ms` (the two spans
  less the waits inside them), `wait_ms` (those waits: the host blocked on
  the card) and `waits` (their number);
- `phase_ms(snap, name, phase)`: the device milliseconds of `phase` in each
  unprofiled record of the device phases `name` (CUDA events).
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def snapshot() -> Optional[dict]:
    try:
        from centerpose_tpu_torch.utils import profiler
    except ImportError:
        return None
    read = getattr(profiler, "snapshot", None)
    return None if read is None else read()


def chunks(snap: Optional[dict]) -> List[dict]:
    if not snap:
        return []
    roots = {}
    for name in ("submit", "finish"):
        for r in snap["spans"].get(name, {}).get("records", ()):
            roots.setdefault(r["ids"].get("chunk"), {})[name] = r
    out = []
    for parts in roots.values():
        if len(parts) < 2 or any(r["profiled"] for r in parts.values()):
            continue
        wait = sum(r["wait_ms"] for r in parts.values())
        out.append({"busy_ms": sum(r["ms"] for r in parts.values()) - wait, "wait_ms": wait,
                    "waits": sum((r["counts"] or {}).get("wait", 0) for r in parts.values())})
    return out


def phase_ms(snap: Optional[dict], name: str, phase: str) -> List[float]:
    if not snap:
        return []
    return [r["ms"][phase] for r in snap["phases"].get(name, {}).get("records", ())
            if not r["profiled"] and phase in r["ms"]]


def median(values) -> Optional[float]:
    return statistics.median(values) if values else None
