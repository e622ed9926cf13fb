"""`host_busy_ms.serve`: median ms a chunk that the host works on it (its
`submit` and `finish` spans less the waits inside them), over the chunks
run outside the profiler (`posebench/spans.py`)."""

from posebench import spans


def read(counters, trace):
    return spans.median([c["busy_ms"] for c in spans.chunks(spans.snapshot())])
