"""`syncs_per_chunk.serve`: the program's waits on the card a chunk (each a
synchronisation at a named site), mean over the chunks run outside the
profiler (`posebench/spans.py`)."""

import statistics

from posebench import spans


def read(counters, trace):
    waits = [c["waits"] for c in spans.chunks(spans.snapshot())]
    return statistics.mean(waits) if waits else None
