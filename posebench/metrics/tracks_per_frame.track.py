"""`tracks_per_frame.track`: the tracks the tracker matched a frame (the
program's counter `tracks.matched`, tallied on the frame's `run` span), the
mean over the frames after the video's first (which starts the tracks), run
outside the profiler (`posebench/spans.py`): the tracker's load, fixed by
the traffic. A frame whose detection of an object is lost (its track ages
instead) reads under it. Nothing where the program keeps no such counter."""

import statistics

from posebench import frame_spans, spans


def read(counters, trace):
    matched = [r["counts"]["tracks.matched"] for r in frame_spans.records(spans.snapshot(), "run")
               if r["ids"].get("frame") and "tracks.matched" in (r["counts"] or {})]
    return statistics.mean(matched) if matched else None
