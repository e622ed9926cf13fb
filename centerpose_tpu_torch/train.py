"""Training entry point of the PyTorch package (CenterPose and CenterPoseTrack).

    python -m centerpose_tpu_torch.train --data_dir DATA --compute_dtype bfloat16
    python -m centerpose_tpu_torch.train --data_dir VIDEOS --tracking_task --load_model exp/dlav1_34/default/ckpt

The twin of the JAX package's `train.py` (parity target:
src/main_CenterPose.py:25-191, src/main_CenterPoseTrack.py:118-242): seed, model + Adam, optional resume or
partial init, the epoch loop with periodic validation, best / last /
periodic checkpoints, LR ÷10 at the `--lr_step` epochs (a function of the
update count, `training/trainer.py::make_lr_schedule`). DATA is a tree of
DOPE-style png+json frames (`data/synthetic.py`, or `python -m
centerpose_tpu_torch.scripts.make_synthetic_dataset`; Objectron records
through `scripts/preprocess_tfrecords.py`).

`--tracking_task` trains the tracking model: `preset("centerpose_track")`
with the arch dla_34 whatever `--arch` says, as the JAX CLI does; its
samples carry the previous frame and its noisy heatmaps
(`data/dataset.py`), and `--load_model` initialises it from a trained
CenterPose checkpoint by name and shape, the stems and tracking heads kept
at init (the main_CenterPoseTrack flow).

Flags keep the JAX CLI's names and defaults. Added: `--device` (default
cuda; asked for cuda on a host without one, it raises).

`--num_devices N` trains data-parallel, the JAX CLI's `data` mesh:
`parallel/mesh.py::launch` spawns N ranks, one process each (0 = every
GPU there is; with `--device cpu` one process). On CUDA rank r runs on
`cuda:r` over NCCL and N above the GPU count raises; on the CPU the ranks
join over gloo with one intra-op thread each. `--batch_size` is the global
batch and must be a multiple of N: every rank loads its rows of each global
index batch (`data/loader.py`), the step is the one-process step on the
global batch (`training/trainer.py`), and rank 0 alone writes the
experiment directory. `main` returns rank 0's summary, with every rank's
index slices under `ranks`.

`--debug > 0`: on the first batch of every epoch, before its
step, one eval-mode forward on the device; the reference's pred/GT canvases
of its first sample (`training/debug.py`) go to
`exp/<arch>/<exp_id>/debug/e<epoch>_<canvas>.png` and to the TensorBoard
stream. Accepted and ignored:
`--dcn_bwd` and `--dcn_impl`, the JAX package's TPU knobs: this package has
one DCN forward kernel and one backward kernel template, chosen by the
tensors' device and type.

`--compute_dtype bfloat16` trains in mixed precision: float32 parameters,
BatchNorm statistics and Adam state, the forward in bf16 under autocast
(the DCN kernels with bf16 operands), the loss in float32.

Experiment directory `exp/<arch>/<exp_id>/` (relative to the working
directory, as the JAX CLI's): `opt.txt`, `log.txt`, `scalars.jsonl`, `tb/`,
and checkpoints (`utils/checkpoint.py`) under `ckpt/<step>/` (every epoch),
`best/<step>/` (lowest validation loss) and `epoch_<N>/<step>/` (every
`--save_intervals` epochs), and at the end `summary.json`: the summary
`main(argv)` also returns (the final step, the per-epoch mean losses, each
step's loss, ms per step and the share of it spent waiting for the loader; the debug canvases'
time is left out of the steps' and reported apart).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.dataset import ObjectPoseDataset
from centerpose_tpu_torch.data.loader import DataLoader
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.parallel.mesh import World, launch, replicate
from centerpose_tpu_torch.training.debug import render_train_debug, save_train_debug
from centerpose_tpu_torch.training.trainer import (
    create_train_state,
    debug_forward,
    decode_wire_np,
    make_eval_step,
    make_train_step,
)
from centerpose_tpu_torch.utils.checkpoint import load_checkpoint, load_partial, save_checkpoint
from centerpose_tpu_torch.utils.logger import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch training")
    p.add_argument("--data_dir", required=True, help="root of png+json training data")
    p.add_argument("--val_dir", default="", help="validation data root")
    p.add_argument("--exp_id", default="default")
    p.add_argument("--c", dest="category", default="shoe")
    p.add_argument("--arch", default="dlav1_34")
    p.add_argument("--tracking_task", action="store_true",
                   help="CenterPoseTrack training (dla_34 with the previous-frame stems)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1.25e-4)
    p.add_argument("--num_epochs", type=int, default=0, help="0 = preset default")
    p.add_argument("--lr_step", default="",
                   help="comma-separated epochs for the LR ÷10 drops; empty = preset default (90,120)")
    p.add_argument("--val_intervals", type=int, default=5)
    p.add_argument("--save_intervals", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load_model", default="",
                   help="initialize from this checkpoint directory by name + shape "
                        "(utils/checkpoint.py::load_partial); the optimizer and step start fresh")
    p.add_argument("--seed", type=int, default=317)
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks, one a device; 0 = every GPU (one process on the CPU)")
    p.add_argument("--input_res", type=int, default=512)
    p.add_argument("--num_workers", type=int, default=2,
                   help="parallel loader workers; 0 = synchronous")
    p.add_argument("--loader_mode", choices=("thread", "process"), default="thread",
                   help="worker kind: threads or spawn processes")
    p.add_argument("--dcn_bwd", choices=("auto", "pallas", "autodiff"), default="auto",
                   help="accepted and ignored: the DCN backward is this package's kernel on CUDA")
    p.add_argument("--dcn_impl", choices=("gather", "onehot"), default="gather",
                   help="accepted and ignored: this package has one DCN forward kernel")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16: mixed precision (float32 parameters, optimizer and loss)")
    p.add_argument("--debug", type=int, default=0,
                   help="> 0: the pred/GT debug canvases of each epoch's first batch, "
                        "under <exp_dir>/debug/")
    p.add_argument("--mug", action="store_true",
                   help="cup category: train the non-symmetric mug sub-model")
    p.add_argument("--use_residual", action="store_true",
                   help="scale head predicts log-residuals against the category's dimension_ref")
    p.add_argument("--use_absolute_scale", action="store_true",
                   help="with --use_residual: absolute [w,h,d] reference")
    p.add_argument("--wire", choices=("compact", "f32"), default="compact",
                   help="loader->device format: compact ships uint8 images and heatmaps, "
                        "decoded on the device; f32 ships the normalized tensors")
    p.add_argument("--new_data_augmentation", action="store_true",
                   help="motion blur / downscale / gaussian noise before the affine warp")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def _fetch(stats) -> dict:
    """Every stat of one step as floats, with one copy to the host."""
    keys = list(stats)
    values = torch.stack([stats[k].detach().float() for k in keys]).tolist()
    return dict(zip(keys, values))


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device here (pass --device cpu to train on the CPU)")
        have = torch.cuda.device_count()
        n = args.num_devices or have
        if n > have:
            raise ValueError(f"--num_devices {n}: {have} GPU(s) here")
    else:
        n = args.num_devices or 1
    if n < 1 or args.batch_size % n:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of --num_devices {n}")
    if n == 1:
        return _run(None, args)
    backend = "nccl" if device.type == "cuda" else "gloo"
    summaries = launch(_run, n, (args,), backend=backend, threads=1 if device.type == "cpu" else 0)
    summary = summaries[0]
    summary["ranks"] = [{"rank": r, "indices": s["indices"]} for r, s in enumerate(summaries)]
    return summary


def _config(args):
    cfg = preset(
        "centerpose_track" if args.tracking_task else "centerpose",
        category=args.category,
        arch="dla_34" if args.tracking_task else args.arch,
        batch_size=args.batch_size,
        lr=args.lr,
        input_h=args.input_res,
        input_w=args.input_res,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        mug=args.mug,
        use_residual=args.use_residual,
        use_absolute_scale=args.use_absolute_scale,
    )
    if args.num_epochs:
        cfg = cfg.replace(num_epochs=args.num_epochs)
    if args.lr_step:
        cfg = cfg.replace(lr_step=tuple(int(e) for e in args.lr_step.split(",") if e))
    return cfg


def _run(world: Optional[World], args) -> dict:
    """One rank's training run, or with `world=None` the whole run in this
    process."""
    np.random.seed(args.seed)
    device = torch.device(args.device)
    if device.type == "cuda" and world is not None:
        device = torch.device("cuda", world.rank)
    cfg = _config(args)
    exp_dir = os.path.join("exp", cfg.arch, args.exp_id)
    logger = Logger(exp_dir, cfg) if world is None or world.rank == 0 else _NoLogger()
    try:
        return _train(args, cfg, device, exp_dir, logger, world)
    finally:
        logger.close()


class _NoLogger:
    """The logger of ranks other than 0: they write nothing."""

    def write(self, msg):
        pass

    def scalars(self, step, values, prefix=""):
        pass

    def image(self, step, tag, rgb):
        pass

    def close(self):
        pass


_END = object()


def _train(args, cfg, device, exp_dir, logger, world: Optional[World]) -> dict:
    compact = args.wire == "compact"
    train_ds = ObjectPoseDataset(args.data_dir, cfg, split="train",
                                 new_data_aug=args.new_data_augmentation, compact_wire=compact)
    val_ds = ObjectPoseDataset(args.val_dir or args.data_dir, cfg, split="val", compact_wire=compact)
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    logger.write(f"train {len(train_ds)} samples, {steps_per_epoch} steps/epoch")

    model = create_model(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed),
                         param_dtype=cfg.param_dtype)
    state, tx = create_train_state(cfg, model, steps_per_epoch)
    start_epoch = 0
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    if args.load_model and not args.resume:
        n_ok, n_skip = load_partial(args.load_model, model)
        logger.write(f"partial-init from {args.load_model}: {n_ok} tensors loaded, "
                     f"{n_skip} kept at init")
    if args.resume:
        state, step = load_checkpoint(ckpt_dir, state)
        start_epoch = step // steps_per_epoch
        logger.write(f"resumed from step {step} (epoch {start_epoch})")
    rank, size = (0, 1) if world is None else (world.rank, world.size)
    if world is not None:
        replicate(world, model)
    save = rank == 0

    step_fn = make_train_step(cfg, model, tx, world)
    eval_fn = make_eval_step(cfg, model, world)
    # Parallel prefetching loader (DataLoader(num_workers) parity,
    # main_CenterPose.py:70-78): host augmentation overlaps the device step.
    loader_args = dict(num_workers=args.num_workers, seed=args.seed, mode=args.loader_mode,
                       rank=rank, world=size)
    train_loader = DataLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True, **loader_args)
    val_loader = DataLoader(val_ds, cfg.batch_size, shuffle=False, drop_last=False, **loader_args)
    metadata = {"config": dataclasses.asdict(cfg)}

    best = float("inf")
    epochs, step_ms, wait_ms, debug_ms, step_loss, indices = [], [], [], [], [], []
    for epoch in range(start_epoch + 1, cfg.num_epochs + 1):
        t0 = time.time()
        agg = {}
        n_steps = 0
        train_loader.set_epoch(epoch)
        indices.append([b.tolist() for b in train_loader.index_batches()])
        batches = iter(train_loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, _END)
            t_step = time.perf_counter()
            if batch is _END:
                break
            t_run = t_step
            if args.debug > 0 and n_steps == 0 and save and batch is not None:
                _debug_canvases(cfg, model, batch, epoch, exp_dir, logger)
                t_run = time.perf_counter()
                debug_ms.append((t_run - t_step) * 1e3)
            state, stats = step_fn(state, batch)
            if stats is None:                   # a rank's slice lost every sample
                logger.write(f"epoch {epoch}: a global batch skipped (a rank has no sample)")
                continue
            stats = _fetch(stats)               # one fetch, which waits for the step
            wait_ms.append((t_step - t_wait) * 1e3)
            step_ms.append((t_step - t_wait + time.perf_counter() - t_run) * 1e3)
            step_loss.append(stats["loss"])
            n_steps += 1
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + v
        agg = {k: v / max(n_steps, 1) for k, v in agg.items()}
        logger.scalars(epoch, agg, prefix="train_")
        logger.write(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items())
                     + f" ({time.time() - t0:.1f}s)")
        record = {"epoch": epoch, "steps": n_steps, "train": agg}

        if args.val_intervals > 0 and epoch % args.val_intervals == 0:
            vagg, vn = {}, 0
            for batch in val_loader:
                stats = _fetch(eval_fn(state, batch))
                vn += 1
                for k, v in stats.items():
                    vagg[k] = vagg.get(k, 0.0) + v
            vagg = {k: v / max(vn, 1) for k, v in vagg.items()}
            logger.scalars(epoch, vagg, prefix="val_")
            logger.write(f"val {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in vagg.items()))
            record["val"] = vagg
            if vagg.get("loss", float("inf")) < best:
                best = vagg["loss"]
                if save:
                    save_checkpoint(os.path.join(exp_dir, "best"), state, state.step, metadata)

        if save:
            save_checkpoint(ckpt_dir, state, state.step, metadata)
            if args.save_intervals > 0 and epoch % args.save_intervals == 0:
                save_checkpoint(os.path.join(exp_dir, f"epoch_{epoch}"), state, state.step, metadata)
        epochs.append(record)

    logger.write("training done")
    total = sum(step_ms)
    summary = {"exp_dir": exp_dir, "step": state.step, "epochs": epochs, "loss_per_step": step_loss,
               "ms_per_step": step_ms,
               "loader_wait_ms": wait_ms, "loader_wait_share": sum(wait_ms) / total if total else 0.0,
               "debug_ms": debug_ms}
    if save:
        with open(os.path.join(exp_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    if world is not None:
        summary["indices"] = indices
    return summary


def _debug_canvases(cfg, model, batch, epoch, exp_dir, logger) -> None:
    """`--debug > 0`: the canvases of one batch before its step
    (trains/object_pose.py:218-401)."""
    imgs = render_train_debug(decode_wire_np(batch), debug_forward(cfg, model, batch), cfg)
    save_train_debug(imgs, os.path.join(exp_dir, "debug"), f"e{epoch}_")
    for name, img in imgs.items():
        logger.image(epoch, f"debug/{name}", img)
    logger.write(f"debug canvases saved: {sorted(imgs)}")


if __name__ == "__main__":
    main()
