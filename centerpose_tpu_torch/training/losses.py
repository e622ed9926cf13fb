"""CenterPose training losses with symmetry-argmin GT selection.

Counterpart of `centerpose_tpu/training/losses.py`. Parity targets:
  * `_neg_loss` focal loss with a leading num_symmetry axis on GT
    (src/lib/models/losses.py:47-75);
  * `RegL1Loss` (:156-179, incl. the relative-error val mode), `RegWeightedL1Loss`
    (:245-255);
  * KLD uncertainty losses `RegKLDScaleLoss`/`RegKLDKeyLoss` (:183-227);
  * `ObjectPoseLoss.forward` weighting + per-sample symmetry argmin
    (src/lib/trains/object_pose.py:44-205).

Layouts are the JAX package's: prediction maps are NHWC [B, H, W, D], which is
what `CenterPoseNet.forward` returns (its NCHW interior is transposed once, at
the network's boundary); GT heatmaps are [B, S, H, W, D] (S = num_symmetry);
per-object targets are [B, S, M, D] with flattened-spatial indices `ind`
[B, S, M].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CenterPoseLossConfig:
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    obj_scale_weight: float = 1.0
    tracking_weight: float = 1.0
    tracking_hp_weight: float = 1.0
    hps_uncertainty: bool = False
    obj_scale_uncertainty: bool = False
    kl_scale_uncertainty: float = 0.01
    kl_kps_uncertainty: float = 0.01
    # Residual scale representation (losses.py:165-172 + opts.py:408-420):
    # when set, the train-phase L1 scale loss decodes pred = exp(pred) * ref
    # before comparing against the GT scale target.
    dimension_ref: Optional[Tuple[float, float, float]] = None


# The keys of the stats `centerpose_loss` returns, in its order.
STAT_KEYS = ("hm_loss", "hp_loss", "wh_loss", "obj_scale_loss", "off_loss", "hp_offset_loss",
             "hm_hp_loss", "tracking_loss", "tracking_hp_loss", "loss")


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet-style focal loss, per (batch, symmetry).

    pred: [B, H, W, C] (post-sigmoid, clamped); gt: [B, S, H, W, C].
    Returns [B, S].
    """
    pred = pred[:, None]  # broadcast over symmetry
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = (1.0 - gt) ** 4

    pos_loss = torch.log(pred) * (1.0 - pred) ** 2 * pos
    neg_loss = torch.log(1.0 - pred) * pred ** 2 * neg_w * neg

    axes = (2, 3, 4)
    num_pos = pos.sum(dim=axes)
    pos_loss = pos_loss.sum(dim=axes)
    neg_loss = neg_loss.sum(dim=axes)

    # num_pos==0: loss = -neg_loss; else -(pos+neg)/num_pos (losses.py:72-74).
    return torch.where(
        num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / num_pos.clamp_min(1.0)
    )


def gather_by_ind(feat_map: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather NHWC map at flattened indices: feat [B,H,W,D], ind [B,S,M] → [B,S,M,D]."""
    b, h, w, d = feat_map.shape
    s, m = ind.shape[1], ind.shape[2]
    flat = feat_map.reshape(b, h * w, d)
    idx = ind.reshape(b, s * m, 1).to(torch.int64).expand(-1, -1, d)
    return torch.gather(flat, 1, idx).reshape(b, s, m, d)


def reg_l1_loss(
    feat_map: torch.Tensor,
    mask: torch.Tensor,
    ind: torch.Tensor,
    target: torch.Tensor,
    relative: bool = False,
    dimension_ref: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """RegL1Loss (losses.py:156-179): mask [B,S,M], target [B,S,M,D] → [B,S].

    dimension_ref: the use_residual representation (losses.py:165-172) — the
    head predicts log-residuals; decode pred = exp(pred) * ref before the L1.
    """
    pred = gather_by_ind(feat_map, ind)
    if dimension_ref is not None and not relative:
        pred = torch.exp(pred) * pred.new_tensor(dimension_ref)
    m = mask[..., None].to(pred.dtype)
    if relative:
        tr = torch.where(target == 0, torch.full_like(target, 1e-6), target)
        loss = torch.abs((1.0 * m - pred * m) / tr).sum(dim=(2, 3))
    else:
        loss = torch.abs(target * m - pred * m).sum(dim=(2, 3))
    return loss / (m.sum(dim=(2, 3)) + 1e-4)


def reg_weighted_l1_loss(
    feat_map: torch.Tensor,
    mask: torch.Tensor,
    ind: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """RegWeightedL1Loss (losses.py:245-255): per-coordinate mask [B,S,M,D]."""
    pred = gather_by_ind(feat_map, ind)
    m = mask.to(pred.dtype)
    loss = torch.abs(target * m - pred * m).sum(dim=(2, 3))
    return loss / (m.sum(dim=(2, 3)) + 1e-4)


def _kld_loss(pred_logvar, a, mask, b_const):
    """Shared attenuated-MSE + log-var regularization form (losses.py:197-204)."""
    b = torch.full_like(a, b_const)
    var = torch.exp(pred_logvar)
    loss = (
        pred_logvar
        - torch.log(b)
        + (b * torch.exp(-a / b) + a) / var
        - 1.0
        + 0.5 * torch.abs(var)
    ) * mask
    return loss.sum(dim=(2, 3)) / (mask.sum(dim=(2, 3)) + 1e-6)


def kld_scale_loss(feat_map, unc_map, mask, ind, target, b_const) -> torch.Tensor:
    """RegKLDScaleLoss (losses.py:183-204): mask [B,S,M]."""
    pred = gather_by_ind(feat_map, ind)
    logvar = gather_by_ind(unc_map, ind)
    m = mask[..., None].to(pred.dtype) * torch.ones_like(pred)
    a = (target - pred) ** 2 * m
    return _kld_loss(logvar, a, m, b_const)


def kld_keypoint_loss(feat_map, unc_map, mask, ind, target, b_const) -> torch.Tensor:
    """RegKLDKeyLoss (losses.py:208-227): per-coordinate mask [B,S,M,D]."""
    pred = gather_by_ind(feat_map, ind)
    logvar = gather_by_ind(unc_map, ind)
    m = mask.to(pred.dtype)
    a = (target * m - pred * m) ** 2
    return _kld_loss(logvar, a, m, b_const)


def _sigmoid_clamped(x):
    return torch.sigmoid(x).clamp(1e-4, 1 - 1e-4)


def centerpose_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: CenterPoseLossConfig,
    phase: str = "train",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Full weighted loss with symmetry argmin (trains/object_pose.py:44-205).

    Returns (scalar loss, per-head loss stats dict, chosen symmetry ids [B]).
    """
    train = phase == "train"
    per: Dict[str, torch.Tensor] = {}

    # A bfloat16 network emits bf16 heads; the loss (and its cotangents into
    # the net) are always float32.
    outputs = {k: v.float() for k, v in outputs.items()}

    hm = _sigmoid_clamped(outputs["hm"])
    per["hm_loss"] = focal_loss(hm, batch["hm"])

    if cfg.hps_uncertainty and train:
        per["hp_loss"] = kld_keypoint_loss(
            outputs["hps"],
            outputs["hps_uncertainty"],
            batch["hps_mask"],
            batch["ind"],
            batch["hps"],
            cfg.kl_kps_uncertainty,
        )
    else:
        per["hp_loss"] = reg_weighted_l1_loss(
            outputs["hps"], batch["hps_mask"], batch["ind"], batch["hps"]
        )

    zeros = torch.zeros_like(per["hm_loss"])
    per["wh_loss"] = (
        reg_l1_loss(outputs["wh"], batch["reg_mask"], batch["ind"], batch["wh"])
        if "wh" in outputs and cfg.wh_weight > 0
        else zeros
    )
    if "scale" in outputs and cfg.obj_scale_weight > 0:
        if train and cfg.obj_scale_uncertainty:
            per["obj_scale_loss"] = kld_scale_loss(
                outputs["scale"],
                outputs["scale_uncertainty"],
                batch["reg_mask"],
                batch["ind"],
                batch["scale"],
                cfg.kl_scale_uncertainty,
            )
        else:
            # use_residual applies only on the train-phase plain-L1 branch
            # (trains/object_pose.py:111-117); val keeps the relative loss.
            per["obj_scale_loss"] = reg_l1_loss(
                outputs["scale"],
                batch["reg_mask"],
                batch["ind"],
                batch["scale"],
                relative=not train,
                dimension_ref=cfg.dimension_ref if train else None,
            )
    else:
        per["obj_scale_loss"] = zeros

    per["off_loss"] = (
        reg_l1_loss(outputs["reg"], batch["reg_mask"], batch["ind"], batch["reg"])
        if "reg" in outputs
        else zeros
    )
    per["hp_offset_loss"] = (
        reg_l1_loss(
            outputs["hp_offset"], batch["hp_mask"], batch["hp_ind"], batch["hp_offset"]
        )
        if "hp_offset" in outputs
        else zeros
    )
    if "hm_hp" in outputs:
        per["hm_hp_loss"] = focal_loss(_sigmoid_clamped(outputs["hm_hp"]), batch["hm_hp"])
    else:
        per["hm_hp_loss"] = zeros

    per["tracking_loss"] = (
        reg_l1_loss(
            outputs["tracking"], batch["tracking_mask"], batch["ind"], batch["tracking"]
        )
        if "tracking" in outputs and "tracking" in batch
        else zeros
    )
    per["tracking_hp_loss"] = (
        reg_weighted_l1_loss(
            outputs["tracking_hp"],
            batch["tracking_hp_mask"],
            batch["ind"],
            batch["tracking_hp"],
        )
        if "tracking_hp" in outputs and "tracking_hp" in batch
        else zeros
    )

    weights = {
        "hm_loss": cfg.hm_weight,
        "hp_loss": cfg.hp_weight,
        "wh_loss": cfg.wh_weight,
        "obj_scale_loss": cfg.obj_scale_weight,
        "off_loss": cfg.off_weight,
        "hp_offset_loss": cfg.off_weight,
        "hm_hp_loss": cfg.hm_hp_weight,
        "tracking_loss": cfg.tracking_weight,
        "tracking_hp_loss": cfg.tracking_hp_weight,
    }
    total_bs = sum(w * per[k] for k, w in weights.items())  # [B, S]

    # Per-sample best symmetry (trains/object_pose.py:158-164).
    valid = batch["ind"].sum(dim=2) > 0  # [B, S]
    inf_fill = torch.where(
        valid, torch.zeros_like(total_bs), torch.full_like(total_bs, float("inf"))
    )
    choice = torch.argmin(total_bs.detach() * valid.to(total_bs.dtype) + inf_fill, dim=1)

    def select(x):  # [B, S] -> mean over B at the chosen symmetry
        return torch.take_along_dim(x, choice[:, None], dim=1)[:, 0].mean()

    stats = {k: select(v) for k, v in per.items()}
    loss = sum(weights[k] * stats[k] for k in weights)
    stats["loss"] = loss
    return loss, stats, choice
