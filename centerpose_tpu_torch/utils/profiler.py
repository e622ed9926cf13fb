"""Profiling utilities, the PyTorch package's counterpart of
`centerpose_tpu/utils/profiler.py`.

The reference times stages on the wall clock behind CUDA synchronise fences
(base_detector.py:390-772). Here:
  * `StageTimer`: the same per-stage wall-clock surface (tot/load/pre/net/
    dec/post/merge/pnp/track), whose `sync` waits for the device of a CUDA
    tensor (`torch.cuda.synchronize`) before it reads the clock;
  * `trace(log_dir)`: a `torch.profiler` context recording CPU activity,
    and CUDA activity where there is a GPU, written as a Chrome trace to
    `<log_dir>/trace.json` (Perfetto, chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _fence(value) -> None:
    """Wait for the devices of the CUDA tensors in `value` (a tensor, or a
    list, tuple or dict of them)."""
    if isinstance(value, dict):
        value = list(value.values())
    elif not isinstance(value, (list, tuple)):
        value = [value]
    for device in {t.device for t in value if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self):
        self.times: Dict[str, float] = {}
        self._t = time.perf_counter()

    def stage(self, name: str, sync=None):
        """Record elapsed time since the previous stage mark; with `sync`,
        first wait for the device work that produces it."""
        if sync is not None:
            _fence(sync)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + (now - self._t)
        self._t = now

    def total(self) -> float:
        return sum(self.times.values())

    def format(self) -> str:
        return "|".join(f"{k} {v:.3f}s" for k, v in self.times.items())


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("exp", "trace")):
    """Profile the block: yields the `torch.profiler.profile` (its
    `key_averages()` sums by operator and kernel once the block has ended)
    and writes `<log_dir>/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
