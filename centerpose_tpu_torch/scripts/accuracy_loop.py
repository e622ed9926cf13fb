"""Closed-loop accuracy protocol: synthetic data -> train -> evaluate -> AP,
with the DCN offsets probed before and after training.

    python -m centerpose_tpu_torch.scripts.accuracy_loop                       # res_18 at 256x256
    python -m centerpose_tpu_torch.scripts.accuracy_loop --arch dlav1_34 --input_res 512 --lr 1e-3
    python -m centerpose_tpu_torch.scripts.accuracy_loop --device cpu --arch res_18 --input_res 64 \\
        --train_videos 2 --train_frames 2 --val_videos 1 --val_frames 2 --num_epochs 1 --batch_size 2

Twin of the JAX package's `scripts/accuracy_loop.py`, with its flags and
defaults. It exercises the whole chain the reference exists for: data ->
targets -> loss -> train -> checkpoint -> detector (net -> decode -> PnP ->
scale recovery) -> Objectron AP (eval_image_official.py:129-1183), on
synthetic DOPE-format data with exact ground truth, through the real CLIs:
`python -m centerpose_tpu_torch.train`, then `python -m
centerpose_tpu_torch.evaluate --mode metric` on the `best` checkpoint and
the held-out frames, then `python -m centerpose_tpu_torch.scripts.
probe_dcn_offsets` on the first 8 held-out frames for a freshly built model
and for the trained one. The data come from this
package's generator (`data/synthetic.py::generate_dataset`, the files of
`python -m centerpose_tpu_torch.scripts.make_synthetic_dataset`): training videos
from seed 0, held-out ones from seed 777, each frame an independent scene.

Writes `--out` (default `<work_dir>/ACCURACY.json`) with the JAX artifact's
keys (metric, value, unit, vs_baseline, protocol, ap, num_gt, num_pred) and
`dcn_offset_probe` (at init and after training), `device` (the card's name
and power limit), `loss_by_epoch`, `ms_per_step`, `images_per_s` and
`loader_wait_share`. Every path is relative to the working directory; the
train CLI writes `exp/<arch>/accuracy_loop/` there.

Added to the JAX flags: `--device` (default cuda; the CLIs run there),
`--val_intervals`, `--num_workers`, `--loader_mode` and `--debug` (passed
to the train CLI; the JAX script fixes validation at every 10 epochs), and
`--in_process`, which calls each CLI's `main` in this process instead of a
subprocess (so that a caller can count the kernel launches).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from typing import List

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXP_ID = "accuracy_loop"
PROBE_FRAMES = 8                          # held-out frames the probe runs on (its default)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="synthetic data -> train -> evaluate -> AP")
    p.add_argument("--work_dir", default="exp/accuracy")
    p.add_argument("--train_dir", default="",
                   help="use an existing train set instead of generating {work_dir}/data_train")
    p.add_argument("--val_dir_override", default="", help="use an existing held-out set")
    p.add_argument("--arch", default="res_18")
    p.add_argument("--input_res", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr_step", default="", help="forwarded to train (LR /10 drop epochs)")
    p.add_argument("--train_videos", type=int, default=24)
    p.add_argument("--train_frames", type=int, default=16)
    p.add_argument("--val_videos", type=int, default=6)
    p.add_argument("--val_frames", type=int, default=8)
    p.add_argument("--img_size", type=int, default=480)
    p.add_argument("--dcn_impl", default="gather",
                   help="accepted and forwarded to train, which ignores it")
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--eval_compute_dtype", default="",
                   help="override eval precision (A/B: bfloat16 vs float32)")
    p.add_argument("--out", default="", help="artifact path (default <work_dir>/ACCURACY.json)")
    p.add_argument("--skip_train", action="store_true",
                   help="reuse the existing checkpoint, only evaluate")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--val_intervals", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=2, help="the train CLI's loader workers")
    p.add_argument("--loader_mode", choices=("thread", "process"), default="thread",
                   help="the train CLI's worker kind (process: spawned workers, for many cores)")
    p.add_argument("--debug", type=int, default=0, help="the train CLI's --debug")
    p.add_argument("--device", default="cuda", help="torch device of every CLI (default cuda)")
    p.add_argument("--in_process", action="store_true",
                   help="call each CLI's main in this process instead of a subprocess")
    return p.parse_args(argv)


def run(module: str, argv: List[str], in_process: bool) -> None:
    """`python -m module argv...`, or its `main(argv)` in this process."""
    print(f"+ python -m {module} " + " ".join(argv), flush=True)
    if in_process:
        importlib.import_module(module).main(argv)
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
    subprocess.run([sys.executable, "-m", module, *argv], check=True, env=env)


def count_frames(root: str) -> int:
    return sum(len([f for f in os.listdir(os.path.join(root, d)) if f.endswith(".png")])
               for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def device_line(device: str) -> dict:
    """The device the CLIs ran on: the card's name and, from `nvidia-smi`,
    its power limit."""
    import torch

    from centerpose_tpu_torch.utils.card import card_line

    if not device.startswith("cuda"):
        return {"kind": "cpu", "nvidia_smi": None}
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": card_line(device)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from centerpose_tpu_torch.data.synthetic import generate_dataset

    train_dir = args.train_dir or os.path.join(args.work_dir, "data_train")
    val_dir = args.val_dir_override or os.path.join(args.work_dir, "data_val")
    exp_dir = os.path.join("exp", args.arch, EXP_ID)
    ckpt = os.path.join(exp_dir, "best")
    out = args.out or os.path.join(args.work_dir, "ACCURACY.json")
    os.makedirs(args.work_dir, exist_ok=True)
    dev = ["--device", args.device]

    t0 = time.time()
    if not os.path.isdir(train_dir):
        generate_dataset(train_dir, n_videos=args.train_videos, frames_per_video=args.train_frames,
                         seed=0, width=args.img_size, height=args.img_size)
    if not os.path.isdir(val_dir):
        generate_dataset(val_dir, n_videos=args.val_videos, frames_per_video=args.val_frames,
                         seed=777, width=args.img_size, height=args.img_size)
    data_s = time.time() - t0

    probes = {}

    def probe(tag, weights):
        path = os.path.join(args.work_dir, f"probe_{tag}.json")
        run("centerpose_tpu_torch.scripts.probe_dcn_offsets",
            [*weights, "--arch", args.arch, "--input_res", str(args.input_res), "--data_dir", val_dir,
             "--n_frames", str(PROBE_FRAMES), "--out", path, *dev], args.in_process)
        with open(path) as f:
            probes[tag] = json.load(f)

    probe("init", ["--init"])

    t_train = 0.0
    if not args.skip_train:
        t0 = time.time()
        run("centerpose_tpu_torch.train",
            ["--data_dir", train_dir, "--val_dir", val_dir, "--exp_id", EXP_ID, "--c", "shoe",
             "--arch", args.arch, "--batch_size", str(args.batch_size), "--lr", str(args.lr),
             "--num_epochs", str(args.num_epochs), "--input_res", str(args.input_res),
             "--val_intervals", str(args.val_intervals), "--save_intervals", "50",
             "--dcn_impl", args.dcn_impl, "--compute_dtype", args.compute_dtype,
             "--num_workers", str(args.num_workers), "--loader_mode", args.loader_mode,
             "--debug", str(args.debug), *dev]
            + (["--lr_step", args.lr_step] if args.lr_step else []), args.in_process)
        t_train = time.time() - t0
    summary_path = os.path.join(exp_dir, "summary.json")
    summary = {"step": None, "epochs": [], "ms_per_step": [], "loader_wait_share": None}
    if os.path.isfile(summary_path):                     # absent: --skip_train on another run's ckpt
        with open(summary_path) as f:
            summary = json.load(f)

    report_json = os.path.join(args.work_dir, "report.json")
    eval_dtype = args.eval_compute_dtype or "float32"
    t0 = time.time()
    run("centerpose_tpu_torch.evaluate",
        ["--mode", "metric", "--data_dir", val_dir, "--c", "shoe", "--arch", args.arch,
         "--input_res", str(args.input_res), "--load_model", ckpt, "--report_json", report_json,
         "--compute_dtype", eval_dtype, *dev]
        + (["--max_images", str(args.max_images)] if args.max_images else []), args.in_process)
    eval_s = time.time() - t0
    probe("trained", ["--ckpt", ckpt])

    with open(report_json) as f:
        report = json.load(f)
    fams = report["families"]
    step_ms = summary["ms_per_step"]
    median_ms = float(np.median(step_ms)) if step_ms else None
    artifact = {
        "metric": "heldout_synthetic_ap",
        "value": round(fams["iou3d"]["ap"], 4),
        "unit": "AP@3DIoU>=0.5",
        "vs_baseline": round(fams["iou3d"]["ap"] / 0.9, 4),
        "protocol": {
            "arch": args.arch, "input_res": args.input_res,
            "batch_size": args.batch_size, "lr": args.lr,
            "num_epochs": args.num_epochs,
            "lr_step": args.lr_step,
            "train_frames": count_frames(train_dir),
            "heldout_frames": count_frames(val_dir),
            "img_size": args.img_size,
            "data_s": round(data_s, 1),
            "train_wall_s": round(t_train, 1),
            "eval_wall_s": round(eval_s, 1),
            "compute_dtype": args.compute_dtype,
            "eval_compute_dtype": eval_dtype,
            "chain": "data->targets->loss->train->ckpt->detector->decode->"
                     "pnp->scale-recovery->iou->AP (real train+evaluate CLIs of centerpose_tpu_torch)",
        },
        "ap": {k: round(v["ap"], 4) for k, v in fams.items()},
        "num_gt": report["num_gt"],
        "num_pred": report["num_pred"],
        "dcn_offset_probe": {"init": probes["init"], "trained": probes["trained"]},
        "device": device_line(args.device),
        "steps": summary["step"],
        "loss_by_epoch": [e["train"].get("loss") for e in summary["epochs"]],
        "val_loss_by_epoch": {e["epoch"]: e["val"].get("loss") for e in summary["epochs"] if "val" in e},
        "ms_per_step": median_ms,
        "ms_per_step_mean": float(np.mean(step_ms)) if step_ms else None,
        "images_per_s": args.batch_size / (median_ms * 1e-3) if median_ms else None,
        "loader_wait_share": summary["loader_wait_share"],
        "debug_ms": summary.get("debug_ms", []),
    }
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact["ap"]))
    print(f"wrote {out}")
    return artifact


if __name__ == "__main__":
    main()
