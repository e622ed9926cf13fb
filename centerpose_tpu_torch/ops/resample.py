"""On-device affine warping, counterpart of `centerpose_tpu/ops/resample.py`
(and the tensor twin of `geometry/affine.warp_affine`).

The reference preprocesses on the CPU (cv2.resize + cv2.warpAffine,
base_detector.py:127-133); at serving scale that host stage dominates. This
module does the crop-resize-normalize on the device the images are sent to:
either a bilinear sampler over the affine-transformed coordinate grid, or, for
the axis-aligned transforms serving always produces, two matrix products
against per-axis hat-function weights. Both contractions are ordinary matrix
products and stay `torch.matmul` / `torch.einsum`.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD


def _normalize(out: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(DATA_MEAN, dtype=torch.float32, device=out.device)
    std = torch.tensor(DATA_STD, dtype=torch.float32, device=out.device)
    return (out / 255.0 - mean) / std


def _warp_affine_batch(images, inv_transforms, out_h: int, out_w: int,
                       normalize: bool) -> torch.Tensor:
    """[B, H, W, C] images, [B, 2, 3] dst→src affines → [B, out_h, out_w, C]."""
    b, h, w = images.shape[:3]
    dev = images.device
    img = images.to(torch.float32)
    t = inv_transforms.to(torch.float32)[:, :, :, None, None]   # [B, 2, 3, 1, 1]

    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    src_x = t[:, 0, 0] * xs + t[:, 0, 1] * ys + t[:, 0, 2]      # [B, oh, ow]
    src_y = t[:, 1, 0] * xs + t[:, 1, 1] * ys + t[:, 1, 2]

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]

    flat = img.reshape(b, h * w, -1)
    c = flat.shape[-1]

    def corner(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (
            yi.clamp(0, h - 1).to(torch.int64) * w
            + xi.clamp(0, w - 1).to(torch.int64)
        ).reshape(b, out_h * out_w, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(b, out_h, out_w, c)
        return vals * valid[..., None].to(torch.float32)

    out = (
        corner(y0, x0) * (1 - fy) * (1 - fx)
        + corner(y0, x0 + 1) * (1 - fy) * fx
        + corner(y0 + 1, x0) * fy * (1 - fx)
        + corner(y0 + 1, x0 + 1) * fy * fx
    )
    return _normalize(out) if normalize else out


def warp_affine_device(
    image: torch.Tensor,
    inv_transform: torch.Tensor,
    out_h: int,
    out_w: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Bilinear-warp an [H, W, 3] uint8/float image by a 2x3 affine (dst→src
    mapping), optionally fusing /255 + mean/std normalization.

    `inv_transform` maps OUTPUT pixel coords to SOURCE coords (pass the
    inv=True transform from geometry.affine.get_affine_transform). Samples
    outside the source count 0.
    """
    return _warp_affine_batch(
        image[None], inv_transform[None], out_h, out_w, normalize
    )[0]


def axis_aligned(inv_transforms: Sequence[np.ndarray], tol: float = 1e-9) -> bool:
    """True iff every 2x3 dst→src affine has no rotation/shear component.

    Serving transforms (center crop + scale, rot=0 — base_detector.py:127-133)
    are always axis-aligned; only rotation augmentation during training makes
    them not."""
    return all(
        abs(float(t[0, 1])) <= tol and abs(float(t[1, 0])) <= tol
        for t in inv_transforms
    )


def _hat_weights(scale, shift, out_n: int, in_n: int) -> torch.Tensor:
    """[B, out_n, in_n] separable bilinear weights: W[b, o, i] =
    max(0, 1 - |scale[b]*o + shift[b] - i|). Rows whose source coordinate
    falls outside [-1, in_n] are all-zero — the same zero-border semantics as
    the masked-corner gather in `warp_affine_device`."""
    dev = scale.device
    src = scale[:, None] * torch.arange(out_n, dtype=torch.float32, device=dev)[None, :] \
        + shift[:, None]                                   # [B, out_n]
    d = torch.abs(src[:, :, None] - torch.arange(in_n, dtype=torch.float32, device=dev))
    return torch.clamp_min(1.0 - d, 0.0)                   # [B, out_n, in_n]


def warp_separable_batch(
    images: torch.Tensor,
    transforms: torch.Tensor,
    out_h: int,
    out_w: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Axis-aligned batched warp as two matrix products.

    For transforms with zero rotation/shear the bilinear warp factorizes into
    per-axis hat-function weight matrices: out = Wy @ img @ Wx^T per channel.
    `transforms` are the same dst→src 2x3 affines `warp_affine_device` takes;
    entries [0,1] and [1,0] are assumed zero.
    """
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    img = images.to(torch.float32)
    transforms = transforms.to(torch.float32)
    wy = _hat_weights(transforms[:, 1, 1], transforms[:, 1, 2], out_h, h)
    wx = _hat_weights(transforms[:, 0, 0], transforms[:, 0, 2], out_w, w)
    # [B,out_h,H] @ [B,H,W*C] -> [B,out_h,W*C]; then contract W with Wx.
    tmp = torch.matmul(wy, img.reshape(b, h, -1)).reshape(b, out_h, w, -1)
    out = torch.einsum("bow,bhwc->bhoc", wx, tmp)
    return _normalize(out) if normalize else out


# The separable path makes a float32 copy of the source batch plus dense
# [B, out, in] weight matrices, so its memory grows with SOURCE resolution.
# Above this many source pixels the 4-corner gather warp, whose footprint
# follows the OUTPUT size, is used instead.
_SEPARABLE_SRC_PIXEL_BUDGET = 64 * 512 * 512


def warp_axis_aligned_batch(
    images: torch.Tensor,
    transforms: torch.Tensor,
    out_h: int,
    out_w: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Batched axis-aligned warp: the separable formulation when the source
    batch fits the budget, the gather formulation otherwise. Both have the
    same hat-weight + zero-border semantics."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    if b * h * w <= _SEPARABLE_SRC_PIXEL_BUDGET:
        return warp_separable_batch(images, transforms, out_h, out_w, normalize)
    return _warp_affine_batch(images, transforms, out_h, out_w, normalize)


def preprocess_on_device(
    images: Sequence[np.ndarray],
    inv_transforms: Sequence[np.ndarray],
    out_h: int,
    out_w: int,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Warp+normalize a list of host images into one [N, out_h, out_w, 3]
    batch on `device` (images of differing shapes go one by one).
    Axis-aligned transform sets (all serving paths) take the separable warp;
    rotated ones the gather warp."""
    device = torch.device(device)

    def to_dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    shapes = {im.shape for im in images}
    if len(shapes) == 1:
        batch = to_dev(np.stack(images))
        invs = to_dev(np.stack(inv_transforms).astype(np.float32))
        if axis_aligned(inv_transforms):
            return warp_axis_aligned_batch(batch, invs, out_h, out_w)
        return _warp_affine_batch(batch, invs, out_h, out_w, True)
    return torch.stack(
        [
            warp_affine_device(to_dev(im), to_dev(np.asarray(t, np.float32)), out_h, out_w)
            for im, t in zip(images, inv_transforms)
        ]
    )
