"""Gaussian heatmap target rendering.

The package's own copy of `centerpose_tpu/geometry/gaussian.py`. Parity
targets in the reference: `gaussian_radius` (`src/lib/utils/image.py:103-123`,
the CornerNet IoU>=0.7 radius bound), `gaussian2D`/`draw_umich_gaussian`
(`image.py:126-150`). Two render paths:

  * numpy host path (`draw_gaussian`) for the data pipeline, matching the
    reference's in-place max-composited window writes;
  * a vectorised torch path (`render_gaussians`) that rasterises N gaussians
    into a heatmap on the tensors' device, for the tracker's previous-frame
    heatmaps (`base_detector.py:150-388`), where the reference loops per
    object on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """Minimum gaussian radius keeping IoU >= min_overlap for a (h, w) box."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian2d(shape, sigma: float = 1.0) -> np.ndarray:
    """(h, w) gaussian bump, peak 1, tiny values zeroed like the reference."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """Max-composite a gaussian of integer radius at (x, y) into heatmap, in place."""
    diameter = 2 * radius + 1
    g = gaussian2d((diameter, diameter), sigma=diameter / 6.0)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if left + right <= 0 or top + bottom <= 0:
        return heatmap

    window = heatmap[y - top : y + bottom, x - left : x + right]
    g_win = g[radius - top : radius + bottom, radius - left : radius + right]
    np.maximum(window, g_win * k, out=window)
    return heatmap


def render_gaussians(
    centers: torch.Tensor,
    radii: torch.Tensor,
    amplitudes: torch.Tensor,
    valid: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """Rasterise N gaussians into a (height, width) map, max-composited, on the
    device of `centers`; leading dimensions render several maps in one call.

    Args:
      centers:    (..., N, 2) float (x, y) in output-map pixels.
      radii:      (..., N) float radius per gaussian (sigma = (2r+1)/6).
      amplitudes: (..., N) peak value per gaussian (confidence-scaled heat).
      valid:      (..., N) bool mask; invalid entries contribute nothing.

    Returns (..., height, width). Dense evaluation over the full map per
    gaussian, reduced with max: O(N*H*W) elementwise work, no scatter.
    """
    dev = centers.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]   # H x 1
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]    # 1 x W

    cx = centers[..., 0][..., None, None]                                 # ... x N x 1 x 1
    cy = centers[..., 1][..., None, None]
    sigma = (2.0 * radii + 1.0) / 6.0
    sigma = sigma.clamp_min(1e-6)[..., None, None]
    amp = torch.where(valid, amplitudes, torch.zeros_like(amplitudes))[..., None, None]

    d2 = (xs - cx) ** 2 + (ys - cy) ** 2                                  # ... x N x H x W
    g = amp * torch.exp(-d2 / (2.0 * sigma ** 2))
    return g.max(dim=-3).values
