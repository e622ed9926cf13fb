"""The rank functions that `parallel/mesh.py::launch` spawns to check the
data-parallel path (`tests/test_torch_port_parallel.py`, `chip_smoke.py`
ddp): `train_steps`, one rank's train steps on its rows of a global batch,
held against the one-process step; `counted_run`, the training CLI's rank
function with the DCN kernels' launches of its process.

    ranks = launch(train_steps, 2, (cfg, state_dict, batch, "cpu"), backend="gloo")
    single = train_steps(None, cfg, state_dict, batch, "cpu")

Every rank builds the model of `cfg` from `state_dict` on `device` (with
NCCL, `cuda:<rank>`), broadcasts it from rank 0, and runs
`training/trainer.py::make_train_step(world=...)` on its rows of `batch`
(`shard_batch`); `world=None` runs the one-process step on the whole batch.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops.dcn_bwd import dcn_v2_bwd_fused
from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward
from centerpose_tpu_torch.parallel.mesh import World, replicate, shard_batch
from centerpose_tpu_torch.training.trainer import create_train_state, make_train_step


def train_steps(world: Optional[World], cfg, state_dict: Mapping[str, torch.Tensor],
                batch: Mapping[str, Any], device: str = "cuda", steps: int = 1,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Run `steps` train steps on this rank's rows of the global `batch`, the
    parameters in `dtype` (float32, or float64 for a check on the CPU); on
    CUDA with cuDNN's and matmul's TF32 switched off in this process (a
    spawned rank starts with PyTorch's defaults).

    Returns `ms`, the wall ms of each step after the first (each ended by a
    device synchronise), `launches` and `launches_by_shape` (`launch_counts`),
    and on rank 0 the
    first step's `loss`, `stats`,
    global gradient `norm`, the gradients after the step's clip (`grads`,
    every parameter, the same on every rank) and the BatchNorm running
    statistics after it (`running`), all as CPU tensors or floats."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        if world is not None and dist.get_backend() == "nccl":
            dev = torch.device("cuda", world.rank)
    model = create_model(cfg, device=dev, param_dtype="float32")
    model.load_state_dict(state_dict)
    model = model.to(dtype)
    if world is not None:
        replicate(world, model)
        batch = shard_batch(world, batch)
    state, tx = create_train_state(cfg, model)
    step_fn = make_train_step(cfg, model, tx, world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    before = launch_counts()
    state, stats = step_fn(state, batch)
    sync()
    out: Dict[str, Any] = {}
    if world is None or world.rank == 0:
        out = {
            "loss": float(stats["loss"]),
            "stats": {k: float(v) for k, v in stats.items()},
            "norm": float(tx.norm),
            "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()},
            "running": {n: b.detach().cpu().clone() for n, b in model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))},
        }
    ms = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        state, stats = step_fn(state, batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = ms
    out.update(launch_counts(before))
    return out


def counted_run(world: Optional[World], args, tf32: Optional[Tuple[bool, bool]] = None
                ) -> Dict[str, Any]:
    """`train.py`'s rank function `_run(world, args)` (the whole run with
    `world=None`): its summary, with `launches` and `launches_by_shape`
    (`launch_counts`) added. `tf32`: cuDNN's and matmul's TF32 switches to
    set in this process first (a spawned rank starts with PyTorch's
    defaults)."""
    from centerpose_tpu_torch import train

    if tf32 is not None:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    before = launch_counts()
    summary = train._run(world, args)
    summary.update(launch_counts(before))
    return summary


def launch_counts(before: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The DCN kernels' launches in this process since `before` (an earlier
    return value; since the start without one): `launches`, forward and
    fused backward, and `launches_by_shape`, the forward's by (H, C, Co),
    each counted by the kernel's wrapper where it launches."""
    now = {"launches": {"dcn_v2_fwd": dcn_v2_forward.launches,
                        "dcn_v2_bwd_fused": dcn_v2_bwd_fused.launches},
           "launches_by_shape": Counter(dcn_v2_forward.launches_by_shape)}
    if before is None:
        return now
    return {"launches": {k: v - before["launches"][k] for k, v in now["launches"].items()},
            "launches_by_shape": now["launches_by_shape"] - before["launches_by_shape"]}
