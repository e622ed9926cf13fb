"""Readings that set a cell's thresholds and its `correct` limits, made once
when the cell is defined (never by a benchmark run):

    python -m posebench.readings --workload W --seeds 1,2,3 --what program|control|half_batch
        [--seconds S] [--trace 0|1] [--fault F] [--set key=value ...] [--out FILE]

- `program`: the cell itself, once per seed in this process, with a window
  of `--seconds`: the numbers compared (the lower readings) and the
  end-to-end metrics; with `--fault`, with that fault planted under the
  timed path (the driver's `plant`), an upper reading.
- `control`: the reference against the reference one precision step below
  the configuration's (`reference/precision.py`; bf16 autocast for a
  float32 training step), on the sample a run checks: the upper readings.
- `half_batch` (training cells): the reference against itself with half of
  each batch left out, a fault a training cell's numbers must catch.

Each reading is one JSON line on standard output (and appended to `--out`).
`--set` overrides a traffic parameter, `--config` a configuration's (a JSON
value).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def control_serve(cell):
    from posebench import checks, inputs
    from posebench.drivers.serve import reference_params, served_state
    from posebench.harness import exact_float32
    from posebench.reference import net as refnet
    from posebench.reference import precision
    from posebench.reference import serve as refserve

    c, t = cell.config, cell.traffic
    spec = refnet.spec_of(c)
    out_res = c["input_w"] // c["down_ratio"]
    n = int(t["pool_chunks"]) * int(t["chunk"])
    frames = inputs.smooth_frames(cell.seed, n, t["frame_hw"], t["low_hw"], cell.device)
    net = refnet.build(spec, cell.device, served_state(cell, cell.device))
    pick = np.sort(np.random.default_rng([cell.seed, 1]).choice(n, size=int(t["check_images"]), replace=False))
    params = reference_params(cell)
    with torch.no_grad(), exact_float32():
        ref = refserve.detect(net, frames[pick], params, cell.device)
        with precision.fp8(net):
            ctl = refserve.detect(net, frames[pick], params, cell.device, pnp_operands=torch.bfloat16)
        numbers = checks.compare_boxes([r.boxes for r in ctl], ref, t["vis_thresh"], c["hm_hp_thresh"],
                                       t["frame_hw"], out_res, cell.device)
    numbers["boxes_per_image_reference"] = float(np.mean([len(r.boxes) for r in ref]))
    return numbers


def control_train(cell, fault=None):
    """The reference against itself under bf16 autocast (the control), or
    with half of each batch left out (`fault="half_batch"`), by the train
    driver's numbers."""
    from posebench import weights
    from posebench.drivers import train as trainer
    from posebench.reference import net as refnet
    from posebench.reference import train as reftrain

    c, t = cell.config, cell.traffic
    spec = refnet.spec_of(c)
    state = weights.make_state(spec, cell.seed, cell.device, c["input_w"], c["input_w"] // c["down_ratio"], t["box_px"])
    batches = reftrain.make_batches(cell.seed, trainer.CHECKED_STEPS, int(c["train_batch_size"]),
                                    (c["input_h"], c["input_w"]), c["down_ratio"], t["low_hw"], cell.device)
    ref = trainer.reference_readings(cell, state, batches, cell.device)
    if fault == "half_batch":
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
        other = trainer.reference_readings(cell, state, half, cell.device)
    else:
        other = trainer.reference_readings(cell, state, batches, cell.device, autocast_bf16=True)
    return trainer.numbers_of(other, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", required=True, choices=("program", "control", "half_batch"))
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--config", action="append", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from posebench import harness
    from posebench.run import fix_caches

    fix_caches(str(harness.ROOT))
    if not torch.cuda.is_available():
        print("posebench.readings: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.cell(args.workload, seed, args.seconds, bool(args.trace))
        cell.fault = args.fault
        for target, pairs in ((cell.traffic, args.set), (cell.config, args.config)):
            for kv in pairs:
                k, v = kv.split("=", 1)
                target[k] = json.loads(v)
        t0 = time.perf_counter()
        row = {"workload": cell.name, "seed": seed, "what": args.what, "fault": args.fault,
               "card": torch.cuda.get_device_name(0)}
        if args.what == "control":
            row["numbers"] = {"serve": control_serve, "train": control_train}[cell.traffic["driver"]](cell)
        elif args.what == "half_batch":
            row["numbers"] = control_train(cell, fault="half_batch")
        else:
            res = harness.driver(cell.traffic["driver"]).run(cell, t0)
            row.update(end_to_end=res.end_to_end, checks=res.checks, correct=res.correct, numbers=res.numbers,
                       attempted=res.attempted, failed=res.failed, memory_peak_bytes=res.memory_peak_bytes,
                       counters={k: v for k, v in res.counters.items() if isinstance(v, (int, float, str))})
            if res.trace is not None:
                row["busy_s"], row["window_s"] = res.trace.busy_s, res.trace.window_s
                row["breakdown"] = res.trace.breakdown()
                from posebench.run import metrics_of
                row["per_layer"] = metrics_of(harness.benchmark(), cell, res)
        row["seconds"] = time.perf_counter() - t0
        _emit(row, args.out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
