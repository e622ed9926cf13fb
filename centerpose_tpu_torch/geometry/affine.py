"""Affine crop/resize geometry, cv2-free.

Behavioral parity target: `src/lib/utils/image.py:23-100` in the reference, which maps
between original-image coordinates and the network's input/output grids via a
similarity transform defined by (center, scale, rot, output_size). The reference calls
cv2.getAffineTransform (exact solve from 3 point pairs) and cv2.warpAffine; here the
3-point solve is done with a closed-form 3x3 inverse and warping is a vectorized
bilinear sampler (numpy on the host for preprocessing; the on-device counterpart
is centerpose_tpu_torch/ops/resample.py).

This is the PyTorch package's own copy of the parts of
`centerpose_tpu/geometry/affine.py` that its detector uses.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence[float]]


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine from 3 source → 3 destination points."""
    # [x, y, 1] @ A.T = [x', y'] for each row.
    ones = np.ones((3, 1), dtype=np.float64)
    m = np.hstack([src.astype(np.float64), ones])  # 3x3
    sol = np.linalg.solve(m, dst.astype(np.float64))  # 3x2
    return sol.T.astype(np.float64)  # 2x3


def _rotate_dir(point_xy, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    x, y = point_xy
    return np.array([x * cs - y * sn, x * sn + y * cs], dtype=np.float32)


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def get_affine_transform(
    center: ArrayLike,
    scale: Union[float, ArrayLike],
    rot: float,
    output_size: Sequence[int],
    shift: ArrayLike = (0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 transform mapping a (center, scale, rot) crop to output_size pixels.

    Same point construction as the reference (`image.py:35-68`): the crop is defined
    by its center, a width `scale`, an in-plane rotation, and a shift in crop units;
    three correspondence points (center, upward direction, perpendicular) pin the
    affine exactly.
    """
    center = np.asarray(center, dtype=np.float32)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_dir([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = _third_point(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform_points(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to an (N, 2) array of points."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ t[:, :2].T + t[:, 2]


def transform_preds(
    coords: np.ndarray, center, scale, output_size
) -> np.ndarray:
    """Map (N, 2) network-output coords back to original image coords.

    Preserves the reference's -10000 invalid-point sentinel (`image.py:23-32`).
    """
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    out = affine_transform_points(coords[:, :2], trans)
    invalid = (coords[:, 0] == -10000) & (coords[:, 1] == -10000)
    out[invalid] = -10000.0
    return out


def warp_affine(
    img: np.ndarray, t: np.ndarray, output_size: Sequence[int]
) -> np.ndarray:
    """Bilinear warp of an HxWxC (or HxW) image by a 2x3 affine, cv2-free.

    Matches cv2.warpAffine(flags=INTER_LINEAR, border 0) closely enough for the
    preprocessing path (`base_detector.py:91-148` resizes + crops with this).
    """
    out_w, out_h = int(output_size[0]), int(output_size[1])
    # Invert: destination pixel -> source location.
    t_full = np.vstack([t, [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(t_full)

    ys, xs = np.meshgrid(
        np.arange(out_h, dtype=np.float64),
        np.arange(out_w, dtype=np.float64),
        indexing="ij",
    )
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    h, w = img.shape[:2]
    x0 = np.floor(src_x)
    y0 = np.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi_c = np.clip(yi, 0, h - 1).astype(np.int64)
        xi_c = np.clip(xi, 0, w - 1).astype(np.int64)
        v = img[yi_c, xi_c]
        if img.ndim == 3:
            valid = valid[..., None]
        return np.where(valid, v, 0)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)

    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return out.astype(img.dtype if np.issubdtype(img.dtype, np.floating) else np.float64)
