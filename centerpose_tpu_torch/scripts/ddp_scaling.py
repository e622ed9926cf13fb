"""Data-parallel training time on 1, 2, ... devices at one global batch.

    python -m centerpose_tpu_torch.scripts.ddp_scaling --ranks 1,2,4        # a host with 4 GPUs
    python -m centerpose_tpu_torch.scripts.ddp_scaling --ranks 1,4,4,1      # in turns, to see the spread
    python -m centerpose_tpu_torch.scripts.ddp_scaling --device cpu --ranks 1,2 --input_res 64 \\
        --batch_size 4 --frames 8 --steps 2

For each N of `--ranks`, two runs of the flagship (`preset("centerpose")`,
`--arch`) in float32:

- `cli`: `train.main` with `--num_devices N` (N = 1: one process, no
  process group) on `--frames` generated 640x480 frames
  (`data/synthetic.py`), `--epochs` epochs without validation, PyTorch's
  TF32 defaults. Per step: ms, the loader's wait, and ms less the wait; the
  median of the last over the steps after each epoch's first (NaN with one
  step an epoch).
- `step`: `parallel/step.py::train_steps` on the first global batch of the
  same frames, `--steps` steps, TF32 off: N spawned ranks over NCCL (gloo
  on the CPU), or for N = 1 this process without a process group. ms per
  step after the first, each rank (no loader, no host work between steps).

Prints the device's name and power limit (`nvidia-smi`) and one JSON line a
run; `--out` also writes them all to a JSON file. Every path is relative to
a temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="data-parallel training time on 1..N devices")
    p.add_argument("--ranks", default="1,2,4", help="comma-separated world sizes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", default="dlav1_34")
    p.add_argument("--input_res", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=16, help="the global batch")
    p.add_argument("--frames", type=int, default=64, help="generated frames (2 videos)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps", type=int, default=6, help="train_steps' steps (the first untimed)")
    p.add_argument("--num_workers", type=int, default=4, help="loader workers of each rank")
    p.add_argument("--out", default="")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    from centerpose_tpu_torch import train
    from centerpose_tpu_torch.config import preset
    from centerpose_tpu_torch.data.dataset import ObjectPoseDataset
    from centerpose_tpu_torch.data.loader import DataLoader
    from centerpose_tpu_torch.data.synthetic import generate_dataset
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.parallel import launch
    from centerpose_tpu_torch.parallel.step import train_steps
    from centerpose_tpu_torch.utils.card import card_line

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")          # one host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        smi = card_line(args.device)
        print(smi, flush=True)
    ranks = [int(n) for n in args.ranks.split(",") if n]
    cfg = preset("centerpose", arch=args.arch, input_h=args.input_res, input_w=args.input_res,
                 batch_size=args.batch_size)
    records = []

    def emit(record):
        records.append(record)
        print(json.dumps(record), flush=True)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ddp_scaling_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.time()
        generate_dataset(data, n_videos=2, frames_per_video=args.frames // 2, seed=0, width=640, height=480)
        emit({"data": {"frames": args.frames, "generate_s": time.time() - t0}})
        ds = ObjectPoseDataset(data, cfg, split="train", compact_wire=False)
        batch = next(iter(DataLoader(ds, args.batch_size, shuffle=False, num_workers=0)))
        model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state_dict = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        os.chdir(tmp)
        try:
            for n in ranks:
                t0 = time.time()
                out = train.main(["--data_dir", data, "--device", args.device, "--arch", args.arch,
                                  "--num_devices", str(n), "--input_res", str(args.input_res),
                                  "--batch_size", str(args.batch_size), "--num_workers", str(args.num_workers),
                                  "--num_epochs", str(args.epochs), "--val_intervals", "0",
                                  "--save_intervals", "0", "--exp_id", f"ranks{n}"])
                own = [s - w for s, w in zip(out["ms_per_step"], out["loader_wait_ms"])]
                per_epoch = len(own) // args.epochs
                warm = float(np.median([ms for i, ms in enumerate(own) if i % per_epoch] or [np.nan]))
                emit({"mode": "cli", "ranks": n, "wall_s": time.time() - t0, "steps": out["step"],
                      "ms_per_step": out["ms_per_step"], "loader_wait_ms": out["loader_wait_ms"],
                      "step_ms_less_wait": own, "step_ms_less_wait_median_warm": warm,
                      "images_per_s_warm": args.batch_size * 1e3 / warm,
                      "train_loss": [e["train"]["loss"] for e in out["epochs"]]})

                t0 = time.time()
                step_args = (cfg, state_dict, batch, args.device, args.steps)
                if n == 1:
                    # train_steps turns TF32 off in its process: keep this one's for the next CLI run.
                    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
                    results = [train_steps(None, *step_args)]
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
                else:
                    results = launch(train_steps, n, step_args, backend="nccl" if cuda else "gloo",
                                     threads=0 if cuda else 1)
                medians = [float(np.median(r["ms"])) for r in results]
                emit({"mode": "step", "ranks": n, "wall_s": time.time() - t0, "loss": results[0]["loss"],
                      "ms_per_step_each": [r["ms"] for r in results], "ms_per_step_median": medians,
                      "images_per_s": args.batch_size * 1e3 / max(medians)})
        finally:
            os.chdir(cwd)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi if cuda else args.device, "args": vars(args), "runs": records}, f, indent=1)
    return records


if __name__ == "__main__":
    main()
