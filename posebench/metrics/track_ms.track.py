"""`track_ms.track`: median ms a frame in `Detector.run`'s `track` span (the
tracker's association, Kalman step, scale pool and re-PnP), over the frames
run outside the profiler (`posebench/spans.py`)."""

from posebench import frame_spans, spans


def read(counters, trace):
    return spans.median([r["ms"] for r in frame_spans.records(spans.snapshot(), "track")])
