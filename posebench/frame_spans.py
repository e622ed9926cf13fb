"""What the tracking cell's per-layer readers read of the program's own
telemetry, beside `posebench/spans.py` (whose `snapshot`, `phase_ms` and
`median` they share): the records of one span name that ran outside the
profiler (warm-up, window; the traced segment runs slower). A program
without that telemetry, or without that span, gives none.
"""

from __future__ import annotations

from typing import List, Optional


def records(snap: Optional[dict], name: str) -> List[dict]:
    if not snap:
        return []
    return [r for r in snap["spans"].get(name, {}).get("records", ()) if not r["profiled"]]
