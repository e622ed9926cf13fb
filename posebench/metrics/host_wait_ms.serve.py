"""`host_wait_ms.serve`: median ms a chunk that the host is blocked on the
card (the `wait` spans inside the chunk's `submit` and `finish`), over the
chunks run outside the profiler (`posebench/spans.py`)."""

from posebench import spans


def read(counters, trace):
    return spans.median([c["wait_ms"] for c in spans.chunks(spans.snapshot())])
