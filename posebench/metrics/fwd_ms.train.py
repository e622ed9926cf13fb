"""`fwd_ms.train`: median device ms a train step of the forward: the
`forward` phase of the step's device phases (CUDA events at the step's
boundaries), over the steps run outside the profiler (`posebench/spans.py`)."""

from posebench import spans


def read(counters, trace):
    return spans.median(spans.phase_ms(spans.snapshot(), "step", "forward"))
