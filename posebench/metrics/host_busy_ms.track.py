"""`host_busy_ms.track`: median ms a frame that the host works on it (its
`run` span less the waits inside it), over the frames run outside the
profiler (`posebench/spans.py`)."""

from posebench import frame_spans, spans


def read(counters, trace):
    return spans.median([r["ms"] - r["wait_ms"] for r in frame_spans.records(spans.snapshot(), "run")])
