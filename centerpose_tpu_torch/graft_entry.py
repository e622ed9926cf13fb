"""Entry points of the flagship, the twin of the JAX package's
`__graft_entry__.py`: `entry`, one forward + decode of the flagship with its
variables passed in, and `dryrun_multichip`, one data-parallel train step
over n devices followed by sharded inference.

    python -m centerpose_tpu_torch.graft_entry     # both, on every GPU of the host

`entry(device)` returns `(fn, (params, x))`: `fn(params, images)` runs
`preset("centerpose")` (dlav1_34, float32) through
`torch.func.functional_call` on `params`, the model's state dict (parameters
and BatchNorm buffers, the counterpart of flax's variables), then
`object_pose_decode(k=cfg.K, rep_mode=cfg.rep_mode, inference=True,
fit_gaussian=False)`; `x` is a zero [1, 512, 512, 3] float32 image.

`dryrun_multichip(n_devices, device)` spawns n ranks with
`parallel/mesh.py::launch` (NCCL with rank r on `cuda:r`; gloo on the CPU;
more ranks than GPUs is refused), one sample a rank: each builds the
flagship from seed 0 (rank 0's weights broadcast), takes ONE train step on
its row of the JAX file's batch (`dryrun_batch`: the objects of
`__graft_entry__.py:117-132` from `RandomState(0)`; BatchNorm statistics and
gradients over the whole batch), then runs network + decode on its shard of
`max(res // 2, 64)`-sized images with the stepped parameters. The parent
gathers the shards, checks scores [n, K, 1] finite and kps with n rows, and
prints the JAX file's two "OK" lines (after the card's name and power limit,
on stderr). The resolution is 512 on a GPU; on the
CPU it follows the JAX file's host rule (512 with 8 or more cores, else
128); `CENTERPOSE_DRYRUN_RES` overrides either. The JAX file's virtual CPU
mesh (`XLA_FLAGS`, backend resets) has no counterpart: every rank is a
process.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from centerpose_tpu_torch.config import CenterPoseConfig, preset
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets, stack_batch
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops.decode import object_pose_decode
from centerpose_tpu_torch.parallel.mesh import World, launch, replicate, shard_batch
from centerpose_tpu_torch.parallel.step import launch_counts
from centerpose_tpu_torch.training.trainer import create_train_state, make_train_step
from centerpose_tpu_torch.utils.card import announce, require_device


def entry(device: str = "cuda") -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    dev = require_device(device)
    cfg = preset("centerpose")
    model = create_model(cfg, dev)
    x = torch.zeros((1, cfg.input_h, cfg.input_w, 3), dtype=torch.float32, device=dev)
    params = dict(model.state_dict())

    def fn(params: Dict[str, torch.Tensor], images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            outputs = torch.func.functional_call(model, params, (images,))
        return object_pose_decode(outputs, k=cfg.K, rep_mode=cfg.rep_mode, inference=True,
                                  fit_gaussian=False)

    return fn, (params, x)


def dryrun_res(device: torch.device) -> int:
    default = 512 if device.type == "cuda" or (os.cpu_count() or 1) >= 8 else 128
    return int(os.environ.get("CENTERPOSE_DRYRUN_RES", str(default)))


def dryrun_batch(cfg: CenterPoseConfig, batch_size: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The JAX file's train batch (one centred object a sample, 8 keypoints
    drawn from `RandomState(0)`, images after them) and, drawn next from the
    same generator, the inference images at `max(res // 2, 64)`."""
    res = cfg.input_h
    out_res = cfg.output_h
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(batch_size):
        obj = ObjectAnnotation(
            center=np.array([out_res / 2.0, out_res / 2.0]),
            size=np.array([out_res / 2.0, out_res / 2.0]),
            keypoints=rng.uniform(out_res / 4, 3 * out_res / 4, size=(1, 8, 2)).astype(np.float32),
            keypoints_visible=np.ones((1, 8), bool),
            scale_3d=np.array([1.0, 1.0, 1.0], np.float32),
        )
        samples.append(render_targets([obj], cfg))
    batch = stack_batch(samples)
    batch["input"] = rng.randn(batch_size, res, res, 3).astype(np.float32)
    infer_res = max(res // 2, 64)
    images = rng.randn(batch_size, infer_res, infer_res, 3).astype(np.float32)
    return batch, images


def _dryrun_rank(world: World, cfg: CenterPoseConfig, batch: Dict[str, np.ndarray],
                 images: np.ndarray, device: str) -> Dict[str, Any]:
    """One rank of `dryrun_multichip`: the train step on its rows, then
    network + decode on its shard of `images`. Returns the step's loss (the
    global batch's), the shard's detections and the rank's DCN launches."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", world.rank)
    before = launch_counts()
    model = create_model(cfg, dev, param_dtype="float32")
    replicate(world, model)
    state, tx = create_train_state(cfg, model)
    step = make_train_step(cfg, model, tx, world)
    state, stats = step(state, shard_batch(world, batch))
    loss = float(stats["loss"])
    model.eval()
    shard = torch.from_numpy(shard_batch(world, {"images": images})["images"]).to(dev)
    with torch.no_grad():
        outputs = {k: v.float() for k, v in model(shard).items()}
        dets = object_pose_decode(outputs, k=cfg.K, rep_mode=cfg.rep_mode, inference=True,
                                  fit_gaussian=False)
    return {"loss": loss, "scores": dets["scores"].cpu(), "kps": dets["kps"].cpu(),
            **launch_counts(before)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, Any]:
    dev = require_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} GPU(s) here")
    announce(dev)
    res = dryrun_res(dev)
    cfg = preset("centerpose", input_h=res, input_w=res, batch_size=n_devices)
    batch, images = dryrun_batch(cfg, n_devices)
    ranks = launch(_dryrun_rank, n_devices, (cfg, batch, images, dev.type),
                   backend="nccl" if dev.type == "cuda" else "gloo",
                   threads=1 if dev.type == "cpu" else 0)
    loss = ranks[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    print(f"dryrun_multichip({n_devices}) train OK — {res}x{res} b{n_devices}, loss {loss:.4f}",
          flush=True)
    scores = torch.cat([r["scores"] for r in ranks])
    kps = torch.cat([r["kps"] for r in ranks])
    if tuple(scores.shape) != (n_devices, cfg.K, 1) or kps.shape[0] != n_devices:
        raise RuntimeError(f"dryrun_multichip: scores {tuple(scores.shape)}, kps {tuple(kps.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise RuntimeError("dryrun_multichip: non-finite scores")
    infer_res = images.shape[1]
    print(f"dryrun_multichip({n_devices}) inference OK — sharded run_batch "
          f"{infer_res}x{infer_res} b{n_devices}, K={cfg.K}", flush=True)
    return {"loss": loss, "res": res, "infer_res": infer_res, "scores": scores, "kps": kps,
            "ranks": [{k: r[k] for k in ("loss", "launches", "launches_by_shape")} for r in ranks]}


if __name__ == "__main__":
    fn, args = entry()
    dets = fn(*args)
    print(f"entry OK — scores {tuple(dets['scores'].shape)}", flush=True)
    dryrun_multichip(torch.cuda.device_count())
