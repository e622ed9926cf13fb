"""`dcn_bwd_roofline.train`: the fused DCN backward kernel's share of its
roofline, as %: the least time the card could take for the traced segment's
DCN backward calls (`posebench/flops.py::dcn_bwd_bound_s`, float32 at the
3xTF32 rate, each call at the batch) over the device time of the DCN
backward's kernels (`trace.DCN_BWD`). Nothing when the trace holds none."""

from posebench.flops import dcn_bwd_bound_s
from posebench.trace import DCN_BWD


def read(counters, trace):
    device_s = trace.seconds_matching(DCN_BWD)
    if device_s <= 0:
        return None
    bound = counters["profiled_steps"] * sum(
        dcn_bwd_bound_s(counters["batch"], h, w, c, co, counters["dtype"]) for h, w, c, co in counters["dcn_calls"])
    return 100.0 * bound / device_s
