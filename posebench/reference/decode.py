"""CenterPose decode in plain PyTorch: the benchmark's frozen copy of
`centerpose_tpu_torch/ops/decode.py`, taken when the benchmark was defined, so that a later change to the
port cannot move the yardstick; the tracking model's outputs (uncertainties,
tracking offsets) are left out. Its original docstring follows.

CenterPose decode on tensors, counterpart of `centerpose_tpu/ops/decode.py`.

Parity target: `object_pose_decode` (src/lib/models/decode.py:72-375) plus the
helpers `_nms` (:17-23), `_topk`/`_topk_channel` (:40-68) and the python
gaussian-fit loop (:191-256). Everything — sigmoid, max-pool NMS, top-K,
gathers, displacement grouping, heatmap-peak association, gating, window
extraction and batched gaussian moments — runs as batched tensor operations
on the device of the head maps, with fixed output shapes; nothing crosses to
the host.

Like the JAX package (and unlike the reference's `gpfit.moments`, which swaps
rows and columns when it labels them) the moments use x = column axis, and the
gaussian "fit" is the pure moments estimate.

Head maps are NHWC. They are converted to float32 on entry, whatever type the
network computed in.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

INVALID = -10000.0
_FIT_WIN = 11  # 11x11 window (decode.py:219 `win = 11`)
_FIT_RAN = _FIT_WIN // 2


def sigmoid_clamped(x: torch.Tensor) -> torch.Tensor:
    """models/utils.py:9-11 `_sigmoid`: sigmoid clamped to [1e-4, 1-1e-4]."""
    return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)


def heat_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3x3 max-pool peak suppression (decode.py:17-23). NHWC."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(
        heat.permute(0, 3, 1, 2), kernel, stride=1, padding=pad
    ).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def topk(scores: torch.Tensor, k: int):
    """Two-stage top-K over [B, H, W, C] (decode.py:52-68).

    Returns (score, inds, clses, ys, xs), each [B, K]; `inds` indexes the
    flattened single-class H*W map.
    """
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_scores, cls_inds = torch.topk(flat, k, dim=-1)  # [B, C, K]
    ys = torch.div(cls_inds, w, rounding_mode="floor").to(torch.float32)
    xs = (cls_inds % w).to(torch.float32)

    score, ind = torch.topk(cls_scores.reshape(b, c * k), k, dim=-1)  # [B, K]
    clses = torch.div(ind, k, rounding_mode="floor").to(torch.int32)

    def pick(t):
        return torch.gather(t.reshape(b, c * k), 1, ind)

    return score, pick(cls_inds), clses, pick(ys), pick(xs)


def topk_channel(scores: torch.Tensor, k: int):
    """Per-channel top-K over [B, H, W, C] (decode.py:40-49).

    Returns (score, inds, ys, xs), each [B, C, K].
    """
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    score, inds = torch.topk(flat, k, dim=-1)
    ys = torch.div(inds, w, rounding_mode="floor").to(torch.float32)
    xs = (inds % w).to(torch.float32)
    return score, inds, ys, xs


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather [B, H, W, C] at flattened-spatial indices [B, K] → [B, K, C]."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, ind.to(torch.int64)[..., None].expand(-1, -1, c))


def _batched_gaussian_moments(windows: torch.Tensor):
    """Gaussian parameters by moments for [..., win, win] heatmap windows.

    Returns (height, mu_x, mu_y, std_x, std_y) each [...]. mu are
    window-relative (0..win-1); x = column axis. Equivalent of gpfit.moments
    (gpfit.py:13-26), vectorised.
    """
    win = windows.shape[-1]
    total = windows.sum(dim=(-2, -1)).clamp_min(1e-12)
    rows = torch.arange(win, dtype=torch.float32, device=windows.device)
    mu_y = (windows.sum(dim=-1) * rows).sum(dim=-1) / total
    mu_x = (windows.sum(dim=-2) * rows).sum(dim=-1) / total
    height = windows.amax(dim=(-2, -1))

    # std along each axis from the 1-D profile through the integer centroid
    # (gpfit.py:21-24); the int cast truncates toward zero.
    iy = mu_y.to(torch.int32).clamp(0, win - 1).to(torch.int64)
    ix = mu_x.to(torch.int32).clamp(0, win - 1).to(torch.int64)
    col = torch.gather(
        windows, -1, ix[..., None, None].expand(*ix.shape, win, 1)
    ).squeeze(-1)  # [..., win] profile along y at x=ix
    row = torch.gather(
        windows, -2, iy[..., None, None].expand(*iy.shape, 1, win)
    ).squeeze(-2)  # [..., win] profile along x at y=iy
    col_sum = col.sum(dim=-1).clamp_min(1e-12)
    row_sum = row.sum(dim=-1).clamp_min(1e-12)
    std_y = torch.sqrt(
        torch.abs((rows - mu_y[..., None]) ** 2 * col).sum(dim=-1) / col_sum
    )
    std_x = torch.sqrt(
        torch.abs((rows - mu_x[..., None]) ** 2 * row).sum(dim=-1) / row_sum
    )
    return height, mu_x, mu_y, std_x, std_y


def _heatmap_gaussian_stats(hm_hp_raw, hm_xs_f, hm_ys_f, valid, fit: bool):
    """Batched replacement for the reference's python gaussian-fit loop
    (decode.py:209-256).

    Args:
      hm_hp_raw: [B, H, W, J] pre-NMS sigmoid keypoint heatmaps.
      hm_xs_f/hm_ys_f: [B, J, K] filtered peak coords (INVALID where bad).
      valid: [B, J, K] bool.
      fit: fit gaussian parameters; if False, mean=peak, std=1, height=peak value.

    Returns (mean_xy [B,J,K,2], std_xy [B,J,K,2], height [B,J,K]).
    """
    b, h, w, j = hm_hp_raw.shape
    k = hm_xs_f.shape[-1]
    ran = _FIT_RAN
    dev = hm_hp_raw.device

    hm = hm_hp_raw.permute(0, 3, 1, 2)  # [B, J, H, W]
    padded = F.pad(hm, (ran, ran, ran, ran))
    hp, wp = h + 2 * ran, w + 2 * ran
    flat = padded.reshape(b, j, hp * wp)

    # Window origin on the padded map; the int cast truncates toward zero.
    x0 = hm_xs_f.to(torch.int32).clamp(0, w - 1).to(torch.int64)
    y0 = hm_ys_f.to(torch.int32).clamp(0, h - 1).to(torch.int64)
    d = torch.arange(_FIT_WIN, dtype=torch.int64, device=dev)
    rows_idx = y0[..., None, None] + d[:, None]          # [B,J,K,11,1]
    cols_idx = x0[..., None, None] + d[None, :]          # [B,J,K,1,11]
    idx = (rows_idx * wp + cols_idx).reshape(b, j, k * _FIT_WIN * _FIT_WIN)
    windows = torch.gather(flat, 2, idx).reshape(b, j, k, _FIT_WIN, _FIT_WIN)

    peak_val = windows[..., ran, ran]
    if fit:
        height, mu_x, mu_y, std_x, std_y = _batched_gaussian_moments(windows)
        mean_x = hm_xs_f + mu_x - ran
        mean_y = hm_ys_f + mu_y - ran
    else:
        height = peak_val
        mean_x, mean_y = hm_xs_f, hm_ys_f
        std_x = torch.ones_like(mean_x)
        std_y = torch.ones_like(mean_y)

    mean = torch.stack([mean_x, mean_y], dim=-1)
    std = torch.stack([std_x, std_y], dim=-1)
    invalid = torch.full_like(mean, INVALID)
    mean = torch.where(valid[..., None], mean, invalid)
    std = torch.where(valid[..., None], std, invalid)
    height = torch.where(valid, height, torch.full_like(height, INVALID))
    return mean, std, height


def object_pose_decode(
    outputs: Dict[str, torch.Tensor],
    *,
    k: int = 100,
    rep_mode: int = 1,
    inference: bool = True,
    fit_gaussian: bool = True,
    apply_sigmoid: bool = True,
    balance_coefficient: float = 1.0,
    hm_hp_thresh: float = 0.1,
) -> Dict[str, torch.Tensor]:
    """Decode raw head maps (NHWC, stride-4 grid) into top-K detections.

    Mirrors decode.py:72-375 with `Inference=True` extras when `inference`.
    All outputs are fixed-shape float32 tensors keyed like the reference's
    detections dict (and like the JAX package's).
    """
    outputs = {name: v.to(torch.float32) for name, v in outputs.items()}
    heat = outputs["hm"]
    kps_map = outputs["hps"]
    b, h, w, _ = heat.shape
    j = kps_map.shape[-1] // 2
    dev = heat.device

    if apply_sigmoid:
        heat = sigmoid_clamped(heat)
    heat_n = heat_nms(heat)
    scores, inds, clses, ys, xs = topk(heat_n, k)

    # Center + displacement keypoints [B, K, 2J] (x,y interleaved).
    kps = gather_feat(kps_map, inds).reshape(b, k, j, 2)
    kps = kps + torch.stack([xs, ys], dim=-1)[:, :, None, :]

    if "reg" in outputs:
        reg = gather_feat(outputs["reg"], inds)
        xs_c = xs + reg[..., 0]
        ys_c = ys + reg[..., 1]
    else:
        xs_c, ys_c = xs + 0.5, ys + 0.5

    kps_displacement_mean = kps.reshape(b, k, 2 * j)

    if "wh" in outputs:
        wh = gather_feat(outputs["wh"], inds)
        bboxes = torch.stack(
            [
                xs_c - wh[..., 0] / 2,
                ys_c - wh[..., 1] / 2,
                xs_c + wh[..., 0] / 2,
                ys_c + wh[..., 1] / 2,
            ],
            dim=-1,
        )
    else:
        bboxes = torch.stack([xs_c, ys_c, xs_c, ys_c], dim=-1)

    kps_heatmap_mean = torch.full((b, k, 2 * j), INVALID, dtype=torch.float32, device=dev)
    kps_heatmap_std = torch.full((b, k, 2 * j), INVALID, dtype=torch.float32, device=dev)
    kps_heatmap_height = torch.full((b, k, j), INVALID, dtype=torch.float32, device=dev)

    if "hm_hp" in outputs:
        hm_hp = outputs["hm_hp"]
        if apply_sigmoid:
            hm_hp = sigmoid_clamped(hm_hp)
        hm_hp_raw = hm_hp  # pre-NMS copy (decode.py:114 hm_hp_copy)
        hm_hp_n = heat_nms(hm_hp)

        kps_jk = kps.permute(0, 2, 1, 3)  # [B, J, K, 2]
        hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp_n, k)  # [B, J, K]

        if "hp_offset" in outputs:
            hp_off = gather_feat(
                outputs["hp_offset"], hm_inds.reshape(b, j * k)
            ).reshape(b, j, k, 2)
            hm_xs = hm_xs + hp_off[..., 0]
            hm_ys = hm_ys + hp_off[..., 1]
        else:
            hm_xs = hm_xs + 0.5
            hm_ys = hm_ys + 0.5

        # Threshold sentinels (decode.py:141-144).
        above = hm_score > hm_hp_thresh
        hm_score = torch.where(above, hm_score, torch.full_like(hm_score, -1.0))
        hm_ys = torch.where(above, hm_ys, torch.full_like(hm_ys, INVALID))
        hm_xs = torch.where(above, hm_xs, torch.full_like(hm_xs, INVALID))

        # Nearest heatmap peak per displacement keypoint (decode.py:146-156).
        hm_xy = torch.stack([hm_xs, hm_ys], dim=-1)  # [B, J, K, 2]
        diff = kps_jk[:, :, :, None, :] - hm_xy[:, :, None, :, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1))  # [B, J, K(det), K(peak)]
        min_ind = torch.argmin(dist, dim=3)
        min_dist = torch.gather(dist, 3, min_ind[..., None]).squeeze(3)
        sel_score = torch.gather(hm_score, 2, min_ind)
        sel_xy = torch.gather(hm_xy, 2, min_ind[..., None].expand(-1, -1, -1, 2))

        # bbox gating (decode.py:158-173).
        l = bboxes[:, None, :, 0]
        t = bboxes[:, None, :, 1]
        r = bboxes[:, None, :, 2]
        bm = bboxes[:, None, :, 3]
        span = torch.maximum(bm - t, r - l)
        bad = (
            (sel_xy[..., 0] < l)
            | (sel_xy[..., 0] > r)
            | (sel_xy[..., 1] < t)
            | (sel_xy[..., 1] > bm)
            | (sel_score < hm_hp_thresh)
            | (min_dist > span * 0.3)
        )
        if rep_mode == 3:
            blended = kps_jk
        elif rep_mode == 4:
            blended = sel_xy
        else:
            blended = torch.where(bad[..., None], kps_jk, sel_xy)
        kps = blended.permute(0, 2, 1, 3).reshape(b, k, 2 * j)

        if inference:
            # 7-condition validity mask (decode.py:183-188).
            scores_e = scores[:, None, :]  # [B, 1, K] broadcast over joints
            ok = (
                (sel_xy[..., 0] > 0.8 * l)
                & (sel_xy[..., 0] < 1.2 * r)
                & (sel_xy[..., 1] > 0.8 * t)
                & (sel_xy[..., 1] < 1.2 * bm)
                & (sel_score > hm_hp_thresh)
                & (min_dist < span * 0.5)
                & (scores_e > hm_hp_thresh)
            )
            invalid = torch.full_like(sel_xy[..., 0], INVALID)
            xs_f = torch.where(ok, sel_xy[..., 0], invalid)
            ys_f = torch.where(ok, sel_xy[..., 1], invalid)

            if rep_mode in (1, 2):
                mean, std, height = _heatmap_gaussian_stats(
                    hm_hp_raw, xs_f, ys_f, ok, fit=fit_gaussian
                )
                kps_heatmap_mean = mean.permute(0, 2, 1, 3).reshape(b, k, 2 * j)
                kps_heatmap_std = std.permute(0, 2, 1, 3).reshape(b, k, 2 * j)
                kps_heatmap_height = height.permute(0, 2, 1).contiguous()
    else:
        kps = kps.reshape(b, k, 2 * j)

    def gathered(name, dim, transform=None):
        if name in outputs:
            v = gather_feat(outputs[name], inds)
            if transform is not None:
                v = transform(v)
            return v.reshape(b, k, dim)
        return torch.zeros((b, k, dim), dtype=torch.float32, device=dev)

    obj_scale = gathered("scale", 3)

    dets = {
        "bboxes": bboxes,
        "scores": scores[..., None],
        "kps": kps,
        "clses": clses[..., None].to(torch.float32),
        "obj_scale": obj_scale,
        "kps_displacement_mean": kps_displacement_mean,
    }
    if inference:
        dets.update(
            kps_heatmap_mean=kps_heatmap_mean,
            kps_heatmap_std=kps_heatmap_std,
            kps_heatmap_height=kps_heatmap_height,
        )
    return dets
