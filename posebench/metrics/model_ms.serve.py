"""`model_ms.serve`: median device ms a chunk from before the frames'
upload to after decode (the Detector's device phase `model`, CUDA events),
over the chunks run outside the profiler (`posebench/spans.py`)."""

from posebench import spans


def read(counters, trace):
    return spans.median(spans.phase_ms(spans.snapshot(), "model", "model"))
