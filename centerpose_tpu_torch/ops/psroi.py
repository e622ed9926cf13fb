"""Deformable position-sensitive ROI pooling (DCNv2Pooling), the PyTorch
package's copy of `centerpose_tpu/ops/psroi.py`.

Parity target: the reference DCNv2 extension's second op,
`dcn_v2_psroi_pooling_forward` (DCNv2/src/cpu/dcn_v2_psroi_pooling_cpu.cpp:
58-146, the `DCNv2Pooling` module of DCNv2/dcn_v2.py:187-221). No CenterPose
model uses it; it is part of the extension's public surface.

Semantics (per output element (n, ctop, ph, pw)):
  * ROI corners are rounded to integers with C's `round()` (half away from
    zero), scaled by `spatial_scale`, shifted by -0.5, with the end corner
    inclusive (+1 before scaling); width and height floored at 0.1.
  * The (ph, pw) bin starts at roi_start + bin_size*index, displaced by the
    normalised offset trans[n, class_id*2(+1), part_h, part_w] * trans_std
    * roi_size (zero when `trans is None`).
  * `sample_per_part`² sub-samples are bilinearly interpolated from the
    position-sensitive input channel c = (ctop*group_size + gh)*group_size
    + gw; samples outside [-0.5, dim-0.5] are left out of the average,
    in-range ones clamp to [0, dim-1].
  * Output = masked mean (0 where no sample lands in range).

Plain torch ops over dense [N, O, P, P, S, S] sample grids, one gather from
the flattened input; autograd gives the backward (the JAX package's is XLA
autodiff; the op is not a Pallas kernel). Layout: the reference module's
NCHW, input [B, C_in, H, W] with C_in = output_dim * group_size², output
[N, output_dim, P, P].
"""

from __future__ import annotations

from typing import Optional

import torch


def _round_c(v: torch.Tensor) -> torch.Tensor:
    """C `round()`: half away from zero (`torch.round` is half to even)."""
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def dcn_v2_psroi_pooling(
    x: torch.Tensor,
    rois: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
    *,
    spatial_scale: float,
    pooled_size: int,
    output_dim: int,
    group_size: int = 1,
    part_size: Optional[int] = None,
    sample_per_part: int = 4,
    trans_std: float = 0.0,
) -> torch.Tensor:
    """[N, output_dim, P, P] pooled features.

    x:     [B, C_in, H, W] features, C_in == output_dim * group_size**2.
    rois:  [N, 5] rows of (batch_index, x1, y1, x2, y2) in image coordinates.
    trans: [N, 2*num_classes, part_size, part_size] normalised offsets, or
           None for the no-trans path.
    """
    B, C, H, W = x.shape
    P, S = pooled_size, sample_per_part
    ps = P if part_size is None else part_size
    if C != output_dim * group_size * group_size:
        raise ValueError(f"C_in={C} != output_dim*group_size^2="
                         f"{output_dim * group_size * group_size}")
    num_classes = 1 if trans is None else trans.shape[1] // 2
    channels_each_class = output_dim // num_classes
    dev = x.device
    fdtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(fdtype)

    # Per-bin index tables.
    bins = torch.arange(P, device=dev)
    part = ((bins * ps) // P).clamp(0, ps - 1)
    group = ((bins * group_size) // P).clamp(0, group_size - 1)
    ctop = torch.arange(output_dim, device=dev)
    class_id = ctop // channels_each_class
    c_idx = (ctop[:, None, None] * group_size + group[None, :, None]) * group_size \
        + group[None, None, :]                                             # [O, P, P]

    r = rois.to(fdtype)
    b = r[:, 0].long()
    start_w = _round_c(r[:, 1]) * spatial_scale - 0.5
    start_h = _round_c(r[:, 2]) * spatial_scale - 0.5
    end_w = (_round_c(r[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (_round_c(r[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = (end_w - start_w).clamp_min(0.1)
    roi_h = (end_h - start_h).clamp_min(0.1)

    def per_roi(v):                                  # [N] -> [N, 1, 1, 1]
        return v[:, None, None, None]

    if trans is None:
        trans_x = trans_y = torch.zeros((), dtype=fdtype, device=dev)
    else:
        t = trans.to(fdtype)
        trans_x = t[:, class_id * 2][:, :, part][:, :, :, part] * trans_std       # [N, O, P, P]
        trans_y = t[:, class_id * 2 + 1][:, :, part][:, :, :, part] * trans_std

    fbins = bins.to(fdtype)
    wstart = fbins[None, None, None, :] * per_roi(roi_w / P) + per_roi(start_w) \
        + trans_x * per_roi(roi_w)
    hstart = fbins[None, None, :, None] * per_roi(roi_h / P) + per_roi(start_h) \
        + trans_y * per_roi(roi_h)
    wstart, hstart = torch.broadcast_tensors(wstart, hstart)             # [N, O, P, P]

    sub = torch.arange(S, dtype=fdtype, device=dev)
    sub_w = (roi_w / P / S)[:, None, None, None, None, None]
    sub_h = (roi_h / P / S)[:, None, None, None, None, None]
    ws = wstart[..., None, None] + sub[None, None, None, None, None, :] * sub_w
    hs = hstart[..., None, None] + sub[None, None, None, None, :, None] * sub_h
    # [N, O, P, P, S, S]
    valid = (ws >= -0.5) & (ws <= W - 0.5) & (hs >= -0.5) & (hs <= H - 0.5)
    wc = ws.clamp(0.0, W - 1.0)
    hc = hs.clamp(0.0, H - 1.0)
    x0 = torch.floor(wc)
    y0 = torch.floor(hc)
    dx = wc - x0
    dy = hc - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp_max(W - 1)
    y1i = (y0i + 1).clamp_max(H - 1)

    flat = xf.reshape(-1)
    base = (b[:, None, None, None, None, None] * C + c_idx[None, ..., None, None]) * H

    def at(yi, xi):
        return flat[(base + yi) * W + xi]

    val = ((1 - dx) * (1 - dy) * at(y0i, x0i) + (1 - dx) * dy * at(y1i, x0i)
           + dx * (1 - dy) * at(y0i, x1i) + dx * dy * at(y1i, x1i))
    val = torch.where(valid, val, torch.zeros((), dtype=fdtype, device=dev))
    cnt = valid.sum(dim=(-1, -2)).to(fdtype)                               # [N, O, P, P]
    total = val.sum(dim=(-1, -2))
    out = torch.where(cnt > 0, total / cnt.clamp_min(1.0), torch.zeros((), dtype=fdtype, device=dev))
    return out.to(x.dtype)
