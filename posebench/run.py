"""Run one cell of the benchmark once, on the CUDA device of this machine.

    python -m posebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and driver are
found by name (`posebench/harness.py`). `--trace 0` prints the cell's
end-to-end metrics, measured in an untraced window; `--trace 1` runs the same
window, then a short segment under the profiler, and prints the cell's
per-layer metrics. Either way the outputs of the window are checked against
the plain reference (`posebench/reference/`) once the window has closed.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with `--trace 1`
`breakdown`), then `checks`: every number compared with its limit, which
are also the last lines of standard error. Without a CUDA device, or with
fewer than the cell asks for, or if JAX or the JAX package was loaded, the
run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

# One host thread for the math libraries: the host half of a cell is Python
# and small arrays, where thread pools add only wake-ups and noise.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "centerpose_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (`centerpose_tpu_torch` is not `centerpose_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def fix_caches(root) -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    port's own nvcc builds already go to `centerpose_tpu_torch/build/`)."""
    cache = os.path.join(root, ".posebench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def result_line(cell, result, metrics, device_info) -> dict:
    line = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": device_info}
    if result.trace is not None:
        line["breakdown"] = result.trace.breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in result.checks}
    return line


def metrics_of(bench: dict, cell, result) -> dict:
    """The cell's end-to-end metrics (`--trace 0`) or its per-layer ones
    (`--trace 1`) that have a reading."""
    from posebench.harness import applies, metric_reader

    out = {}
    if not cell.trace:
        for m in bench["end_to_end"]:
            if applies(m, cell.name):
                out[m["name"]] = {"value": result.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if applies(m, cell.name):
            value = metric_reader(m["name"])(result.counters, result.trace)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from posebench import harness

    fix_caches(str(harness.ROOT))
    import torch

    cell = harness.cell(args.workload, args.seed, args.seconds, bool(args.trace))
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"posebench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.driver(cell.traffic["driver"]).run(cell, T_PROCESS)
    bench = harness.benchmark()
    metrics = metrics_of(bench, cell, result)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": result.memory_peak_bytes}
    if result.trace is not None:
        device_info["busy_s"] = result.trace.busy_s
        device_info["window_s"] = result.trace.window_s
    bad = loaded_forbidden()
    if bad:
        print(f"posebench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, result, metrics, device_info)
    limited = {c["name"] for c in result.checks}
    for name, value in (result.numbers or {}).items():
        if name not in limited and isinstance(value, (int, float)):
            print(f"number {name}: {value!r} (not limited)", file=sys.stderr)
    for c in result.checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
