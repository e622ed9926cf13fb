"""Training-throughput benchmark: the flagship's full train step at 512x512 on
one GPU, the twin of the JAX package's `scripts/bench_train.py`.

    python -m centerpose_tpu_torch.scripts.bench_train
    BENCH_TRAIN_TRACK=1 python -m centerpose_tpu_torch.scripts.bench_train

Prints the card's name and power limit to stderr, then ONE JSON line
{"metric", "value", "unit", "vs_baseline"} with the JAX script's keys and
metric name. `vs_baseline` is null: the JAX script's 5.52 images/s was a
TPU's train step, and no GPU figure of the reference's train step is
published.

The recorded protocol is the JAX script's: `create_train_state` +
`make_train_step` (`training/trainer.py`), bf16 mixed precision (float32
parameters, optimizer and loss), batch 16, random weights from seed 0, a
synthetic batch from `RandomState(0)` (`make_batch`) moved to the device
once; one warm step, then 5 timed steps, each ended by fetching its loss
(a device synchronise); images/s = BATCH / the fastest step.

Env overrides, as in the JAX script: BENCH_TRAIN_BATCH (16),
BENCH_TRAIN_DTYPE (bfloat16 | float32), BENCH_TRAIN_ARCH (dlav1_34; the
decomposition probes dlav0_34 and dla_34), BENCH_TRAIN_RES (512),
BENCH_TRAIN_TRACK=1 (the `centerpose_track` preset: dla_34 with the
previous-frame stems and tracking heads, synthetic pre_img / pre_hm /
pre_hm_hp). BENCH_TRAIN_DCN (gather | onehot | onehot_exact) and
BENCH_TRAIN_BWD (auto | pallas | autodiff) are accepted and ignored: they
choose among the JAX package's TPU DCN implementations, and this package
has one per device (the CUDA kernels on a GPU, the plain version on the
CPU). The JAX presets' `remat_dcn` / `remat_stem` are not passed: this
package's config has no such fields.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from centerpose_tpu_torch.config import CenterPoseConfig, preset
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets, stack_batch
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training.trainer import create_train_state, make_train_step
from centerpose_tpu_torch.utils.card import announce, require_device

DCN_CHOICES = ("gather", "onehot", "onehot_exact")
BWD_CHOICES = ("auto", "pallas", "autodiff")
TIMED_STEPS = 5


def settings(environ: Optional[Mapping[str, str]] = None) -> dict:
    """The run's settings from the environment (the JAX script's names and
    defaults)."""
    env = os.environ if environ is None else environ
    s = {
        "batch": int(env.get("BENCH_TRAIN_BATCH", "16")),
        "dtype": env.get("BENCH_TRAIN_DTYPE", "bfloat16"),
        "arch": env.get("BENCH_TRAIN_ARCH", "dlav1_34"),
        "arch_set": "BENCH_TRAIN_ARCH" in env,
        "res": int(env.get("BENCH_TRAIN_RES", "512")),
        "track": env.get("BENCH_TRAIN_TRACK", "") == "1",
    }
    for name, choices, default in (("BENCH_TRAIN_DCN", DCN_CHOICES, "onehot"),
                                   ("BENCH_TRAIN_BWD", BWD_CHOICES, "auto")):
        if env.get(name, default) not in choices:
            raise ValueError(f"{name}={env[name]!r}: one of {choices}")
    return s


def config(s: Mapping) -> CenterPoseConfig:
    kw = dict(input_h=s["res"], input_w=s["res"], compute_dtype=s["dtype"])
    if not s["track"] or s["arch_set"]:
        kw["arch"] = s["arch"]
    return preset("centerpose_track" if s["track"] else "centerpose", **kw)


def make_batch(cfg: CenterPoseConfig, batch: int, res: int, track: bool) -> Dict[str, np.ndarray]:
    """The JAX script's synthetic batch (`scripts/bench_train.py:62-87`),
    value for value: one object a sample from `RandomState(0)`, targets by
    `render_targets`, images (and for the tracking model the previous-frame
    inputs) drawn after them."""
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(batch):
        obj = ObjectAnnotation(
            center=np.array([64.0, 64.0]),
            size=np.array([30.0, 30.0]),
            keypoints=rng.uniform(10, 100, size=(cfg.num_symmetry, 8, 2)).astype(np.float32),
            keypoints_visible=np.ones((cfg.num_symmetry, 8), bool),
            scale_3d=np.array([1.0, 1.0, 1.0], np.float32),
            tracking=np.array([1.5, -1.0], np.float32) if track else None,
            tracking_hp=rng.uniform(-2, 2, (8, 2)).astype(np.float32) if track else None,
        )
        samples.append(render_targets([obj], cfg))
    out = stack_batch(samples)
    out["input"] = rng.randn(batch, res, res, 3).astype(np.float32)
    if track:
        # Synthetic previous-frame inputs (the dataset renders these from the
        # previous frame; the step's cost is set by their shapes).
        out["pre_img"] = rng.randn(batch, res, res, 3).astype(np.float32)
        out["pre_hm"] = rng.rand(batch, res, res, 1).astype(np.float32)
        out["pre_hm_hp"] = rng.rand(batch, res, res, 8).astype(np.float32)
    return out


def metric_name(s: Mapping, arch: str) -> str:
    return (f"train_images_per_sec_per_chip_{s['res']}x{s['res']}_"
            f"{'track_' if s['track'] else ''}{arch}_b{s['batch']}")


def main(device: str = "cuda") -> dict:
    dev = require_device(device)
    s = settings()
    cfg = config(s)
    announce(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_batch(cfg, s["batch"], s["res"], s["track"]).items()}
    model = create_model(cfg, dev, param_dtype="float32")
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx)

    state, stats = step(state, batch)          # warm
    float(stats["loss"])
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        float(stats["loss"])                   # waits for the step's last kernel
        times.append(time.perf_counter() - t0)
    img_s = s["batch"] / min(times)
    record = {"metric": metric_name(s, cfg.arch), "value": round(img_s, 2),
              "unit": "images/sec", "vs_baseline": None}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
