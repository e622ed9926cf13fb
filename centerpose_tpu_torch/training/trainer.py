"""Train and eval step (the reference's BaseTrainer/ModelWithLoss), eager PyTorch.

Counterpart of `centerpose_tpu/training/trainer.py`. Parity targets:
`ModelWithLoss`+`run_epoch` (src/lib/trains/base_trainer.py:17-143 — forward +
loss, grad-clip 100, Adam) and the epoch loop's defaults in
main_CenterPose.py:25-191 (LR ÷10 at lr_step epochs).

    model = create_model(cfg, device="cuda")
    state, tx = create_train_state(cfg, model, steps_per_epoch=len(loader))
    train_step = make_train_step(cfg, model, tx)
    state, stats = train_step(state, batch)      # batch: dict of numpy arrays / tensors

Differences from the JAX package, by design: there is no jit and no mesh (one
device; data parallel is a later slice); the model owns its parameters and
BatchNorm statistics and the optimizer its moments, so a step updates them in
place and hands back the same `TrainState`; the device is the model's. On a
CUDA model every `DeformConvBlock` runs the forward kernel and, in the
backward pass, the fused backward kernel (`ops/dcn_fwd.py::DCNv2Function`).

Library difference kept: `nn.BatchNorm2d` updates `running_var` with the
unbiased batch variance (n/(n-1)), flax with the biased one; the normalisation
inside a step is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD, CenterPoseConfig
from centerpose_tpu_torch.training.losses import CenterPoseLossConfig, centerpose_loss


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
    moments and the update count; `step()` reads every parameter's `.grad`."""

    def __init__(self, params: Iterable[nn.Parameter], lr_at: Callable[[int], float],
                 max_norm: float):
        self.params: List[nn.Parameter] = list(params)
        self.lr_at = lr_at
        self.max_norm = float(max_norm)
        self.count = 0
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
    point: freeze what a fine-tuning run leaves alone before the call."""
    trainable = [p for p in model.parameters() if p.requires_grad]
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


def make_train_step(cfg: CenterPoseConfig, model: nn.Module, tx: ClippedAdam):
    """`step(state, batch) -> (state, stats)`: forward in train mode (batch
    statistics, running statistics updated), loss, backward, clip, Adam.
    `stats` are detached 0-d tensors on the model's device (per-head losses,
    `loss`); nothing synchronises with the host. The gradients of the step
    stay in the parameters' `.grad` (after clipping) until the next step."""
    if cfg.tracking_task:
        raise NotImplementedError("the tracking model is not ported yet; see ROADMAP.md")
    loss_cfg = loss_config_from(cfg)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = _to_device(batch, _device_of(model))
        model.train()
        for p in tx.params:
            p.grad = None
        outputs = model(batch["input"])
        loss, stats, _ = centerpose_loss(outputs, batch, loss_cfg, "train")
        loss.backward()
        for p in tx.params:
            # A parameter the forward never reads (the reference keeps an
            # unused `project` conv in its two-level trees) has a zero
            # gradient, as in the JAX package; Adam then leaves it alone.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        tx.step()
        state.step += 1
        return state, {k: v.detach() for k, v in stats.items()}

    return step_fn


def make_eval_step(cfg: CenterPoseConfig, model: nn.Module):
    """Validation loss step (test.py / trainer.val parity): running BN stats,
    val-phase loss (relative scale error — trains/object_pose.py:125-128).
    `eval_fn(state, batch) -> stats`."""
    if cfg.tracking_task:
        raise NotImplementedError("the tracking model is not ported yet; see ROADMAP.md")
    loss_cfg = loss_config_from(cfg)

    def eval_fn(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, _device_of(model))
        model.eval()
        with torch.no_grad():
            outputs = model(batch["input"])
            _, stats, _ = centerpose_loss(outputs, batch, loss_cfg, "val")
        return stats

    return eval_fn
