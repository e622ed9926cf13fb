"""`dcn_fwd_roofline.track`: the DCN forward kernel's share of its roofline
at batch 1 in float32, as %: the least time the card could take for the
traced segment's DCN calls (`posebench/flops.py::dcn_fwd_bound_s`, 16 calls
a frame at B=1) over the device time of the DCN forward's kernels
(`trace.DCN_FWD`). Nothing when the trace holds no such kernel."""

from posebench.flops import dcn_fwd_bound_s
from posebench.trace import DCN_FWD


def read(counters, trace):
    device_s = trace.seconds_matching(DCN_FWD)
    if device_s <= 0:
        return None
    bound = counters["profiled_frames"] * sum(
        dcn_fwd_bound_s(1, h, w, c, co, counters["dtype"]) for h, w, c, co in counters["dcn_calls"])
    return 100.0 * bound / device_s
