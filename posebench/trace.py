"""The traced part of a `--trace 1` run: `torch.profiler` over a short steady
segment, reduced in memory (no chrome trace is written).

`profile(fn)` runs `fn()` between two device synchronisations under the
profiler and returns a `Trace`. With `steady=<span>`, `fn` runs its cycles
each inside `span(<span>)`, and the trace keeps only the cycles after the
first: from the start of the second to the end of the last, so that neither
the filling of a pipeline after the first synchronisation nor its draining
before the last counts.

- `window_s`: length of the segment (or of the kept cycles);
- `busy_s`: union of the device's kernel and copy intervals within it;
- `kernel_s`: device seconds by kernel name;
- `gaps`: the device's longest idle intervals, each named by the innermost
  span of the benchmark (`record_function` names starting `posebench.`)
  running on the host at its middle, else by the innermost host operation
  there; the rest summed as "shorter gaps".

`KERNEL_KINDS` is a frozen copy of `chip_smoke.py::KERNEL_KINDS` (taken when
the benchmark was defined): kernel families by the first pattern a kernel's
name contains; here the float32 forward's weight split and split-K sum count
as the DCN forward (the original counted the sum as backward).
`DCN_FWD` and `DCN_BWD` match the DCN kernels' names whole.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

KERNEL_KINDS = (
    ("dcn forward", ("dcn_v2_fwd", "f32_weight_split", "f32_sum_partials")),
    ("dcn backward", ("dcn_v2_bwd", "weight_fragments", "sum_partials")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass", "dgrad", "wgrad", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("copy / cast", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)
DCN_FWD = re.compile(r"\b(dcn_v2_fwd|f32_weight_split|f32_sum_partials)")
DCN_BWD = re.compile(r"\b(dcn_v2_bwd|weight_fragments|sum_partials)")
SPAN_PREFIX = "posebench."
NAMED_GAPS = 400                 # the longest idle gaps named by the host's work


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    gaps: List[Tuple[str, float]]

    def seconds_matching(self, pattern: "re.Pattern") -> float:
        return sum(t for name, t in self.kernel_s.items() if pattern.search(name))

    def breakdown(self) -> dict:
        kinds = Counter()
        for name, t in self.kernel_s.items():
            low = name.lower()
            kinds[next((k for k, pats in KERNEL_KINDS if any(p in low for p in pats)), "other")] += t
        by_host = Counter()
        for name, t in self.gaps:
            by_host[name] += t
        return {"device_ops": [[k, v] for k, v in kinds.most_common(10)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(10)]}


def span(name: str):
    """A host span of the benchmark around a call into one layer."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def profile(fn: Callable[[], None], steady: Optional[str] = None) -> Trace:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s, None if steady is None else SPAN_PREFIX + steady)


def reduce(events, window_s: float, steady: Optional[str] = None) -> Trace:
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPAN_PREFIX):
                device.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    if steady is not None:
        cycles = sorted((s, e) for s, e, name in host if name == steady)
        if len(cycles) < 2:
            raise ValueError(f"a steady trace needs two {steady} spans or more, found {len(cycles)}")
        lo, hi = cycles[1][0], cycles[-1][1]
        window_s = (hi - lo) / 1e6
        device = [(max(s, lo), min(e, hi), name) for s, e, name in device if e > lo and s < hi]
        host = [h for h in host if h[2] != steady]
    kernel_s: Counter = Counter()
    for start, end, name in device:
        kernel_s[name] += (end - start) / 1e6
    intervals = sorted((s, e) for s, e, _ in device)
    merged: List[List[float]] = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) / 1e6
    if steady is not None:                       # idle at the kept cycles' two ends
        merged = [[lo, lo]] + merged + [[hi, hi]]
    host.sort()
    starts = [h[0] for h in host]
    spans = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])), reverse=True)
    gaps = [(_host_name(host, starts, (a + b) / 2), d / 1e6) for d, a, b in spans[:NAMED_GAPS]]
    gaps.append(("shorter gaps", sum(d for d, _, _ in spans[NAMED_GAPS:]) / 1e6))
    return Trace(window_s=window_s, busy_s=busy_s, kernel_s=dict(kernel_s), gaps=gaps)


def _host_name(host, starts, t) -> str:
    """The innermost benchmark span covering host time `t`, else the
    innermost host operation, else "idle host"."""
    covering = [h for h in host[:bisect.bisect_right(starts, t)] if h[1] >= t]
    if not covering:
        return "idle host"
    spans = [h for h in covering if h[2].startswith(SPAN_PREFIX)]
    pick = spans or covering
    return min(pick, key=lambda h: h[1] - h[0])[2]
