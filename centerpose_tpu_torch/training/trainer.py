"""Train and eval step (the reference's BaseTrainer/ModelWithLoss), eager PyTorch.

Counterpart of `centerpose_tpu/training/trainer.py`. Parity targets:
`ModelWithLoss`+`run_epoch` (src/lib/trains/base_trainer.py:17-143 — forward +
loss, grad-clip 100, Adam) and the epoch loop's defaults in
main_CenterPose.py:25-191 (LR ÷10 at lr_step epochs).

    model = create_model(cfg, device="cuda")
    state, tx = create_train_state(cfg, model, steps_per_epoch=len(loader))
    train_step = make_train_step(cfg, model, tx)
    state, stats = train_step(state, batch)      # batch: dict of numpy arrays / tensors

Data parallel (`make_train_step(..., world=...)`, `train.py --num_devices`):
the JAX step with a mesh, one process per device (`parallel/mesh.py`). Each
rank runs the step on its rows of the global batch; BatchNorm takes the
global batch's statistics (`models/layers.py::BatchNorm2d`); each rank's
loss is weighted by its share of the global rows and the gradients summed
over the world with one all-reduce before the clip, so every rank applies
the one-process step's update on the global batch (the losses are means
over samples). The stats are all-reduced to the global batch's means.

Differences from the JAX package, by design: there is no jit; the model owns its parameters and
BatchNorm statistics and the optimizer its moments, so a step updates them in
place and hands back the same `TrainState`; the device is the model's. On a
CUDA model every `DeformConvBlock` runs the forward kernel and, in the
backward pass, the fused backward kernel (`ops/dcn_fwd.py::DCNv2Function`).
For the tracking model (`cfg.tracking_task`, CenterPoseTrack) both steps also
give the network the batch's `pre_img`, `pre_hm` and `pre_hm_hp`.

Mixed precision (`compute_dtype="bfloat16"`, `train.py --compute_dtype
bfloat16`), with the JAX package's semantics: parameters, BatchNorm running
statistics and Adam's moments stay float32 (build the model with
`create_model(cfg, param_dtype="float32")`); the forward runs under
`torch.autocast(..., torch.bfloat16)`, so the convolutions compute in bf16,
the deformable convolutions too (their operands are cast to bf16 in
`models/layers.py::DCN`, and both their kernels then take bf16); the heads
reach the loss as float32 (`training/losses.py`); gradients reach the float32
parameters through the casts, as float32. The float32 step runs without
autocast, as before. Autocast's op lists are not flax's: under autocast on
the GPU GroupNorm returns float32 where flax's bf16 GroupNorm returns bf16;
the ReLU and the bf16 convolution after it see the same values either way.

Library difference kept: `nn.BatchNorm2d` updates `running_var` with the
unbiased batch variance (n/(n-1)), flax with the biased one; the normalisation
inside a step is the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD, CenterPoseConfig
from centerpose_tpu_torch.models.layers import BatchNorm2d
from centerpose_tpu_torch.parallel.mesh import World, all_reduce_grads
from centerpose_tpu_torch.training.losses import STAT_KEYS, CenterPoseLossConfig, centerpose_loss
from centerpose_tpu_torch.utils import profiler

PHASES = ("forward", "loss", "backward", "optimizer")   # the step's spans and device phases


def decode_wire(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Undo the loader's compact wire encoding on the tensors' device: uint8
    images -> mean/std-normalised float32, uint8 [0, 255] heatmaps ->
    float32 / 255. Float tensors pass through untouched."""
    out = dict(batch)
    for k in ("input", "pre_img"):
        v = out.get(k)
        if v is not None and v.dtype == torch.uint8:
            mean = torch.tensor(DATA_MEAN, dtype=torch.float32, device=v.device)
            std = torch.tensor(DATA_STD, dtype=torch.float32, device=v.device)
            out[k] = (v.to(torch.float32) / 255.0 - mean) / std
    for k in ("hm", "hm_hp", "pre_hm", "pre_hm_hp"):
        v = out.get(k)
        if v is not None and v.dtype == torch.uint8:
            out[k] = v.to(torch.float32) / 255.0
    return out


def decode_wire_np(batch) -> Dict[str, np.ndarray]:
    """Host-side `decode_wire` for the debug renderers: numpy arrays in and
    out, the same float32 arithmetic on CPU tensors."""
    decoded = decode_wire({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    return {k: v.numpy() for k, v in decoded.items()}


def make_lr_schedule(cfg: CenterPoseConfig) -> Callable[[int], Callable[[int], float]]:
    """Piecewise step decay: LR ÷10 at each lr_step epoch boundary, expressed
    in steps via steps_per_epoch. `schedule(steps_per_epoch)(count)` is the
    rate of the update that follows `count` earlier ones (the boundary step
    itself already runs at the lower rate)."""

    def schedule(steps_per_epoch: int):
        boundaries = sorted(int(e) * steps_per_epoch for e in cfg.lr_step)

        def lr_at(count: int) -> float:
            lr = cfg.lr
            for boundary in boundaries:
                if count >= boundary:
                    lr = lr * 0.1
            return lr

        return lr_at

    return schedule


class ClippedAdam:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8, no weight
    decay) at the scheduled rate: base_trainer.py:94-97. The clip scales by
    `max_norm / max(norm, max_norm)`, the JAX package's form
    (`torch.nn.utils.clip_grad_norm_` divides by `norm + 1e-6`). Holds the
    moments and the update count; `step()` reads every parameter's `.grad`
    and keeps the global norm it clipped by in `norm`."""

    def __init__(self, params: Iterable[nn.Parameter], lr_at: Callable[[int], float],
                 max_norm: float):
        self.params: List[nn.Parameter] = list(params)
        self.lr_at = lr_at
        self.max_norm = float(max_norm)
        self.count = 0
        self.norm = None
        self.adam = torch.optim.Adam(
            self.params, lr=lr_at(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0
        )

    def step(self) -> torch.Tensor:
        """One update from the gradients in place. Returns the global norm of
        the gradients before clipping (a 0-d tensor; no host sync)."""
        missing = [i for i, p in enumerate(self.params) if p.grad is None]
        if missing:
            raise RuntimeError(f"ClippedAdam.step: {len(missing)} parameters have no gradient")
        grads = [p.grad for p in self.params]
        norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        scale = self.max_norm / norm.clamp_min(self.max_norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1
        self.norm = norm
        return norm


def make_optimizer(cfg: CenterPoseConfig, params: Iterable[nn.Parameter],
                   steps_per_epoch: int = 1000) -> ClippedAdam:
    return ClippedAdam(params, make_lr_schedule(cfg)(steps_per_epoch), cfg.grad_clip_norm)


@dataclasses.dataclass
class TrainState:
    """`model` holds the parameters and BatchNorm statistics, `tx` the Adam
    moments; `step` counts the updates made."""

    step: int
    model: nn.Module
    tx: ClippedAdam


def create_train_state(cfg: CenterPoseConfig, model: nn.Module,
                       steps_per_epoch: int = 1000) -> Tuple[TrainState, ClippedAdam]:
    """State and optimizer for `model` (from `models/factory.py::create_model`,
    which draws the weights from its generator and places them on its
    device). The optimizer holds the parameters that require grad at this
    point: freeze what a fine-tuning run leaves alone before the call. They
    must be float32, for a bf16 `compute_dtype` too (mixed precision: the
    step casts at use, Adam updates float32), or all float64 (the CPU
    checks of the data-parallel step, where float32 rounding is amplified
    past their tolerance)."""
    trainable = [p for p in model.parameters() if p.requires_grad]
    kinds = {p.dtype for p in trainable}
    if kinds not in ({torch.float32}, {torch.float64}):
        raise ValueError(
            f"create_train_state: parameters of type {sorted(map(str, kinds))}; training "
            "keeps float32 parameters (create_model(cfg, param_dtype='float32'))"
        )
    tx = make_optimizer(cfg, trainable, steps_per_epoch)
    return TrainState(step=0, model=model, tx=tx), tx


def loss_config_from(cfg: CenterPoseConfig) -> CenterPoseLossConfig:
    return CenterPoseLossConfig(
        hm_weight=cfg.hm_weight,
        wh_weight=cfg.wh_weight,
        off_weight=cfg.off_weight,
        hp_weight=cfg.hp_weight,
        hm_hp_weight=cfg.hm_hp_weight,
        obj_scale_weight=cfg.obj_scale_weight,
        tracking_weight=cfg.tracking_weight,
        tracking_hp_weight=cfg.tracking_hp_weight,
        hps_uncertainty=cfg.hps_uncertainty,
        obj_scale_uncertainty=cfg.obj_scale_uncertainty,
        kl_scale_uncertainty=cfg.kl_scale_uncertainty,
        kl_kps_uncertainty=cfg.kl_kps_uncertainty,
        dimension_ref=cfg.dimension_ref,
    )


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch (numpy arrays or tensors) as tensors on `device`, wire
    encoding undone there."""
    return decode_wire({k: torch.as_tensor(v).to(device) for k, v in batch.items()})


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _compute(cfg: CenterPoseConfig, device: torch.device):
    """The context the network's forward runs in: autocast to bf16 for a
    bf16 `compute_dtype` (mixed precision), nothing for float32."""
    if cfg.compute_dtype == "float32":
        return contextlib.nullcontext()
    if cfg.compute_dtype != "bfloat16":
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}")
    return torch.autocast(device.type, dtype=torch.bfloat16)


def _forward(cfg: CenterPoseConfig, model: nn.Module, batch: Dict[str, torch.Tensor]):
    """The network on the batch's image; the tracking model (CenterPoseTrack)
    also takes the previous frame and its rendered heatmaps."""
    if cfg.tracking_task:
        return model(batch["input"], pre_img=batch.get("pre_img"), pre_hm=batch.get("pre_hm"),
                     pre_hm_hp=batch.get("pre_hm_hp"))
    return model(batch["input"])


def _rows(batch) -> int:
    return 0 if batch is None else int(batch["input"].shape[0])


def _world_mean(stats, rows: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The global batch's mean of per-rank mean `stats` over `rows` rows
    each (a rank without rows passes `stats=None`)."""
    vec = torch.zeros(len(STAT_KEYS) + 1, dtype=torch.float64, device=device)
    if rows:
        vec[:-1] = torch.stack([stats[k].detach().double() for k in STAT_KEYS]) * rows
    vec[-1] = rows
    torch.distributed.all_reduce(vec)
    return {k: (vec[i] / vec[-1]).float() for i, k in enumerate(STAT_KEYS)}


def make_train_step(cfg: CenterPoseConfig, model: nn.Module, tx: ClippedAdam,
                    world: Optional[World] = None):
    """`step(state, batch) -> (state, stats)`: forward in train mode (batch
    statistics, running statistics updated), loss, backward, clip, Adam.
    `stats` are detached 0-d tensors on the model's device (per-head losses,
    `loss`); nothing synchronises with the host. The gradients of the step
    stay in the parameters' `.grad` (after clipping) until the next step.
    Each step is a span `step` (its id the update count before it) over the
    spans of `PHASES`, and on a CUDA model the device phase `step`: five
    CUDA events on the current stream at the phases' boundaries
    (`utils/profiler.py`). `optimizer` covers the zero-filled gradients,
    the all-reduce of a world, the clip and Adam.

    With a `world` (`parallel/mesh.py`; a live process group, of one rank
    or more) `batch` is this rank's rows of the global batch (`None` for
    none) and every rank must call the step for every global batch: the
    gradients and the stats are those of the global batch. A global batch of which some rank has no row
    (its every sample dropped by the dataset) is skipped by every rank, and
    the step returns `stats=None`. Over more than one rank the model's
    BatchNorms take the global batch's statistics from here on
    (`models/layers.py::BatchNorm2d.process_group`)."""
    loss_cfg = loss_config_from(cfg)
    parallel = world is not None
    if parallel and world.size > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.process_group = torch.distributed.group.WORLD

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Optional[Dict[str, torch.Tensor]]]:
        device = _device_of(model)
        weight = 1.0
        if parallel:
            rows = _rows(batch)
            counts = torch.tensor([rows, rows == 0], dtype=torch.float64, device=device)
            torch.distributed.all_reduce(counts)
            total, empty = counts.tolist()
            if empty:
                return state, None
            weight = rows / total
        batch = _to_device(batch, device)
        model.train()
        for p in tx.params:
            p.grad = None
        with profiler.span("step", step=state.step):
            phases = profiler.device_phases("step", PHASES, device)
            phases.mark()
            with profiler.span("forward"), _compute(cfg, device):
                outputs = _forward(cfg, model, batch)
            phases.mark()
            with profiler.span("loss"):
                loss, stats, _ = centerpose_loss(outputs, batch, loss_cfg, "train")
            phases.mark()
            with profiler.span("backward"):
                (loss * weight if parallel else loss).backward()
            phases.mark()
            with profiler.span("optimizer"):
                for p in tx.params:
                    # A parameter the forward never reads (the reference keeps an
                    # unused `project` conv in its two-level trees) has a zero
                    # gradient, as in the JAX package; Adam then leaves it alone.
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if parallel:
                    all_reduce_grads(tx.params)
                    stats = _world_mean(stats, rows, device)
                tx.step()
            phases.mark()
        state.step += 1
        return state, {k: v.detach() for k, v in stats.items()}

    return step_fn


def make_eval_step(cfg: CenterPoseConfig, model: nn.Module, world: Optional[World] = None):
    """Validation loss step (test.py / trainer.val parity): running BN stats,
    val-phase loss (relative scale error — trains/object_pose.py:125-128).
    `eval_fn(state, batch) -> stats`. With a `world` (a live process group)
    `batch` is this rank's rows of a global batch (`None` for none) and the
    stats are the global batch's means; every rank calls it for every
    global batch."""
    loss_cfg = loss_config_from(cfg)
    parallel = world is not None

    def eval_fn(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        device = _device_of(model)
        stats = None
        if batch is not None:
            batch = _to_device(batch, device)
            model.eval()
            with torch.no_grad(), _compute(cfg, device):
                outputs = _forward(cfg, model, batch)
                _, stats, _ = centerpose_loss(outputs, batch, loss_cfg, "val")
        if parallel:
            return _world_mean(stats, _rows(batch), device)
        return stats

    return eval_fn


def debug_forward(cfg: CenterPoseConfig, model: nn.Module, batch) -> Dict[str, np.ndarray]:
    """The network's head maps for one batch as `train.py --debug` draws
    them (`training/debug.py`): an eval-mode forward (running statistics) on
    the model's device in the step's compute type, fetched as float32 NHWC
    numpy arrays."""
    device = _device_of(model)
    batch = _to_device(batch, device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), _compute(cfg, device):
            outputs = _forward(cfg, model, batch)
    finally:
        model.train(was_training)
    return {k: v.float().cpu().numpy() for k, v in outputs.items()}
