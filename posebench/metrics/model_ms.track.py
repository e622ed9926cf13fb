"""`model_ms.track`: median device ms a tracked frame from before the
frame's upload to after decode (the device phase `model` of
`Detector.run`, CUDA events), over the frames run outside the profiler
(`posebench/spans.py`). Nothing where the program records no such phase."""

from posebench import spans


def read(counters, trace):
    return spans.median(spans.phase_ms(spans.snapshot(), "model", "model"))
