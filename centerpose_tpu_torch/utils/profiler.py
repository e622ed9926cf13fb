"""The port's telemetry: host spans, waits on the device, counters and device
phases in one process-wide registry, and the profiler that puts them on the
kernels' timeline.

    from centerpose_tpu_torch.utils import profiler

    with profiler.span("finish", chunk=7):        # a host span, ids inherited by what nests
        dets = profiler.fetch(t, "fetch")         # `wait.fetch` (host blocked on the card), then `fetch`
        profiler.count("boxes", 12)               # a counter, also tallied on the enclosing root span
    phases = profiler.device_phases("step", ("forward", "loss"), device)
    phases.mark(); ...; phases.mark(); ...; phases.mark()   # CUDA events at the boundaries
    snap = profiler.snapshot()                    # plain dicts: spans, counters, phases

* `span(name, **ids)`: start and end on `time.perf_counter_ns`, the parent
  span, the ids (a chunk, a step; a nested span inherits its parent's),
  its self time (less the spans inside it) and its wait time (the `wait`
  spans inside it). Records go to a bounded buffer per name (the last
  `CAPACITY`, with a running count and sum), so a long run holds a fixed
  amount. While a `torch.profiler` is active, and only then, a span also
  enters `record_function("centerpose.<name>")` with its ids as the args and
  is flagged `profiled`; otherwise it costs two clock reads and an append.
* `wait(site, device)`: a span of kind *wait*, `wait.<site>`, around an
  explicit synchronisation of the device's current stream, placed just
  before each blocking copy, which would synchronise anyway. It splits the
  host's time into working and waiting without changing what the card
  does; on the CPU it records a zero-length wait. `upload` and `fetch` are
  the blocking copies, each behind its wait.
* `synced(site)`: a wait, `wait.<site>`, around a call that synchronises
  by itself (a linear-algebra error check), with no drain before it.
* `count(name, n)`: a counter. The kernel wrappers' own counters
  (`dcn_v2_forward.launches`, `dcn_v2_bwd_fused.launches`, the PnP kernel's
  `solve_pnp_packed.launches` and `.rows`) are reported beside them by
  `snapshot`, not counted here.
* `device_phases(name, phases, device)`: CUDA events
  (`enable_timing=True`) recorded on the current stream at the phases'
  boundaries, read with `query()` at the next call or at `snapshot()`,
  never by a synchronisation added for them. Nothing on the CPU.
* `strict_syncs()`: inside the block any synchronisation with the card that
  is not inside a `wait` or a span opened with `syncs=True` (the copy a
  wait guards) raises (`torch.cuda.set_sync_debug_mode("error")`).
* `trace(log_dir)`: a `torch.profiler` over the block, written as a Chrome
  trace; `idle_by_span(prof)` puts the device's idle time in it down to
  the innermost `centerpose.*` span running on the host.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import sys
import threading
import time
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

PREFIX = "centerpose."
CAPACITY = 4096          # records kept per span or phase name
OUTSIDE = "(no span)"    # `idle_by_span`'s name for idle time outside every span

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Series:
    """One name's bounded records, with the count and sum over all of them."""

    __slots__ = ("count", "total", "records")

    def __init__(self):
        self.count = 0
        self.total = 0
        self.records = collections.deque(maxlen=CAPACITY)

    def add(self, record, amount) -> None:
        self.count += 1
        self.total += amount
        self.records.append(record)


class Span:
    """One host span; `span()` makes it, `with` records it. After the block,
    `seconds` is its length."""

    __slots__ = ("_reg", "name", "kind", "ids", "syncs", "parent", "start_ns", "end_ns", "child_ns",
                 "wait_ns", "profiled", "counts", "_root", "_rf", "_mode")

    def __init__(self, reg: "Registry", name: str, kind: str, ids: dict, syncs: bool):
        self._reg, self.name, self.kind, self.ids, self.syncs = reg, name, kind, ids, syncs
        self.parent = None
        self.counts = None
        self.child_ns = self.wait_ns = 0

    def __enter__(self) -> "Span":
        stack = self._reg._stack()
        if stack:
            parent = stack[-1]
            self.parent = parent.name
            if parent.ids:
                self.ids = {**parent.ids, **self.ids}
            self._root = parent._root
        else:
            self._root = self
            self.counts = {}
        self.profiled = _profiler_enabled()
        self._rf = None
        if self.profiled:
            args = ",".join(f"{k}={v}" for k, v in self.ids.items()) or None
            self._rf = torch.profiler.record_function(PREFIX + self.name, args)
            self._rf.__enter__()
        self._mode = None
        if self.syncs and self._reg.strict:
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = time.perf_counter_ns()
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = self._reg._stack()
        stack.pop()
        length = end - self.start_ns
        if self.kind == "wait":
            self.wait_ns = length
        if stack:
            parent = stack[-1]
            parent.child_ns += length
            parent.wait_ns += self.wait_ns
        self._root = None
        self._reg._record(self, length)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> dict:
        length = self.end_ns - self.start_ns
        return {"name": self.name, "kind": self.kind, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "ms": length / 1e6, "self_ms": (length - self.child_ns) / 1e6, "wait_ms": self.wait_ns / 1e6,
                "parent": self.parent, "ids": dict(self.ids), "profiled": self.profiled,
                "counts": None if self.counts is None else dict(self.counts)}


class DevicePhases:
    """CUDA events on the current stream at the boundaries of `phases`:
    `mark()` once before the first phase and once after each. Read once the
    last event has completed."""

    __slots__ = ("_reg", "name", "phases", "ids", "profiled", "events")

    def __init__(self, reg: "Registry", name: str, phases: tuple, ids: dict, profiled: bool):
        self._reg, self.name, self.phases, self.ids, self.profiled = reg, name, phases, ids, profiled
        self.events = []

    def mark(self) -> None:
        reg = self._reg
        event = reg._free_events.pop() if reg._free_events else torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        if len(self.events) == len(self.phases) + 1:
            reg._pending.append(self)


class _NoPhases:
    """`device_phases` off the card: marks nothing."""

    def mark(self) -> None:
        pass


_NO_PHASES = _NoPhases()


class Registry:
    """The process's spans, counters and device phases (`REGISTRY`; the
    module's functions act on it). A span stack per thread."""

    def __init__(self):
        self.strict = False
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every record, counter and pending phase."""
        self.spans: Dict[str, _Series] = {}
        self.phases: Dict[str, _Series] = {}
        self.counters: collections.Counter = collections.Counter()
        self._pending: collections.deque = collections.deque()
        self._free_events: list = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _series(self, table: Dict[str, _Series], name: str) -> _Series:
        series = table.get(name)
        if series is None:
            series = table[name] = _Series()
        return series

    def _record(self, span: Span, length: int) -> None:
        self._series(self.spans, span.name).add(span, length)

    def span(self, name: str, *, syncs: bool = False, **ids) -> Span:
        return Span(self, name, "work", ids, syncs)

    def wait(self, site: str, device) -> None:
        with self.synced(site):
            if torch.device(device).type == "cuda":
                torch.cuda.current_stream(device).synchronize()

    @contextlib.contextmanager
    def synced(self, site: str):
        with Span(self, "wait." + site, "wait", {}, True) as s:
            self.count("wait")
            yield s

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n
        stack = self._stack()
        if stack:
            counts = stack[0].counts
            counts[name] = counts.get(name, 0) + n

    def device_phases(self, name: str, phases: Sequence[str], device):
        self._resolve()
        if torch.device(device).type != "cuda":
            return _NO_PHASES
        stack = self._stack()
        ids = dict(stack[-1].ids) if stack else {}
        return DevicePhases(self, name, tuple(phases), ids, _profiler_enabled())

    def _resolve(self) -> None:
        """Read the phases whose last event has completed, in order."""
        while self._pending and self._pending[0].events[-1].query():
            ph = self._pending.popleft()
            ev = ph.events
            ms = {p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(ph.phases)}
            self._series(self.phases, ph.name).add({"ids": ph.ids, "profiled": ph.profiled, "ms": ms},
                                                   sum(ms.values()))
            self._free_events.extend(ev)
            ph.events = []

    def snapshot(self) -> dict:
        """Plain copies: `spans` and `phases` by name (`count`, `total_ms`,
        the kept `records`), `counters` (with the kernel wrappers' own)."""
        self._resolve()
        counters = dict(self.counters)
        counters.update(_kernel_launches())
        return {
            "spans": {name: {"count": s.count, "total_ms": s.total / 1e6,
                             "records": [r.as_dict() for r in s.records]} for name, s in self.spans.items()},
            "phases": {name: {"count": s.count, "total_ms": s.total,
                              "records": [{"ids": dict(r["ids"]), "profiled": r["profiled"], "ms": dict(r["ms"])}
                                          for r in s.records]} for name, s in self.phases.items()},
            "counters": counters,
        }


def _kernel_launches() -> Dict[str, int]:
    """The kernels' wrappers' own counters, where their modules are loaded
    (nothing is imported for them)."""
    out = {}
    fwd = sys.modules.get("centerpose_tpu_torch.ops.dcn_fwd")
    if fwd is not None:
        out["dcn_v2_fwd.launches"] = fwd.dcn_v2_forward.launches
        out["dcn_v2_fwd.launches_bf16"] = fwd.dcn_v2_forward.launches_bf16
    bwd = sys.modules.get("centerpose_tpu_torch.ops.dcn_bwd")
    if bwd is not None:
        out["dcn_v2_bwd_fused.launches"] = bwd.dcn_v2_bwd_fused.launches
        out["dcn_v2_bwd_fused.launches_bf16"] = bwd.dcn_v2_bwd_fused.launches_bf16
    pnp = sys.modules.get("centerpose_tpu_torch.ops.pnp")
    if pnp is not None:
        out["pnp.launches"] = pnp.solve_pnp_packed.launches
        out["pnp.rows"] = pnp.solve_pnp_packed.rows
    return out


REGISTRY = Registry()


def span(name: str, *, syncs: bool = False, **ids) -> Span:
    """A host span (`with span("pnp"): ...`). `syncs=True` marks a span whose
    body ends in a synchronisation a `wait` has already drained (a blocking
    copy), which `strict_syncs` then allows."""
    return REGISTRY.span(name, syncs=syncs, **ids)


def wait(site: str, device) -> None:
    """The host waits for `device`'s current stream, in span `wait.<site>`."""
    REGISTRY.wait(site, device)


def count(name: str, n: int = 1) -> None:
    REGISTRY.count(name, n)


def device_phases(name: str, phases: Sequence[str], device):
    """CUDA events at `phases`' boundaries, with the ids of the enclosing
    span."""
    return REGISTRY.device_phases(name, phases, device)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


def upload(array, device, site: str) -> torch.Tensor:
    """A host array (or CPU tensor) on `device`, by a blocking copy behind
    `wait(site)`."""
    REGISTRY.wait(site, device)
    with REGISTRY.span("upload", syncs=True):
        host = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))
        return host.to(device)


def synced(site: str):
    """A wait, `wait.<site>`, around a call that synchronises by itself (a
    linear-algebra error check, a scalar written into a device tensor): the
    whole blocking call counts as waiting, and nothing drains the stream
    before it: `with synced("pnp.svd"): torch.linalg.svd(m)`."""
    return REGISTRY.synced(site)


def fetch(tensor: torch.Tensor, site: str) -> np.ndarray:
    """A tensor as host numpy, by a blocking copy behind `wait(site)`."""
    REGISTRY.wait(site, tensor.device)
    with REGISTRY.span("fetch", syncs=True):
        return tensor.cpu().numpy()


@contextlib.contextmanager
def strict_syncs():
    """Inside the block a synchronisation with the card outside a `wait`
    and the copy it guards raises: every one sits at a named site."""
    saved = torch.cuda.get_sync_debug_mode(), REGISTRY.strict
    torch.cuda.set_sync_debug_mode("error")
    REGISTRY.strict = True
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved[0])
        REGISTRY.strict = saved[1]


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("exp", "trace")):
    """Profile the block: yields the `torch.profiler.profile` (its
    `key_averages()` sums by operator and kernel once the block has ended)
    and writes `<log_dir>/trace.json`. The spans above appear in it as
    `centerpose.<name>` ranges."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def idle_by_span(prof) -> Dict[str, float]:
    """The device's idle seconds in a finished `trace` (or a list of its
    events), from its first device event to its last, each moment put down
    to the innermost `centerpose.*` span running on the host then (by name,
    without the prefix), else to `OUTSIDE`."""
    events: Iterable = prof.events() if hasattr(prof, "events") else prof
    device, spans = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(PREFIX) and not getattr(e, "is_user_annotation", False):
                device.append((start, end))
        elif e.name.startswith(PREFIX):
            spans.append((start, end, e.name[len(PREFIX):]))
    idle: Dict[str, float] = collections.Counter()
    if not device:
        return {}
    device.sort()
    gaps, reach = [], device[0][1]
    for s, e in device[1:]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    spans.sort()
    starts = [s[0] for s in spans]
    for a, b in gaps:
        live = [s for s in spans[:bisect.bisect_left(starts, b)] if s[1] > a]
        cuts = sorted({a, b, *(t for s in live for t in s[:2] if a < t < b)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            inner = [s for s in live if s[0] <= mid <= s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else OUTSIDE
            idle[name] += (hi - lo) / 1e6
    return dict(idle)
