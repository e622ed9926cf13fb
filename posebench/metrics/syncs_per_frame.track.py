"""`syncs_per_frame.track`: the program's waits on the card a steady frame
(each a synchronisation at a named site, tallied on the frame's `run`
span), the median over the frames run outside the profiler
(`posebench/spans.py`)."""

from posebench import frame_spans, spans


def read(counters, trace):
    return spans.median([(r["counts"] or {}).get("wait", 0) for r in frame_spans.records(spans.snapshot(), "run")])
