"""Detection visualization (the reference Debugger's core renders, cv2-free).

Parity target: `Debugger` (src/lib/utils/debugger.py:1-485) essentials: 2D bbox,
3D cuboid wireframe from projected corners, center/keypoint dots, score text is
omitted (no font dependency). Pure numpy pixel drawing — debug path only, never hot.

The PyTorch package's own copy of `centerpose_tpu/utils/visualize.py`: the same
pixels for the same inputs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from centerpose_tpu_torch.geometry.cuboid import CUBOID_EDGES

_COLORS = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
]


def _draw_line(img, p0, p1, color, thickness=2):
    """A (2r+1)-pixel square, r = thickness // 2, at each of 2 x length
    points rounded (half to even) along p0 -> p1, clipped to the image.
    The JAX package's loop over the points, done as one indexed write per
    square offset: the same pixels."""
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(max(abs(p1 - p0).max(), 1)) * 2
    t = np.linspace(0, 1, n)[:, None]
    pts = np.rint(p0 * (1 - t) + p1 * t).astype(np.int64)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x, y = pts[:, 0] + dx, pts[:, 1] + dy
            inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            img[y[inside], x[inside]] = color


def _draw_point(img, p, color, radius=3):
    h, w = img.shape[:2]
    x, y = int(round(p[0])), int(round(p[1]))
    y0, y1 = max(0, y - radius), min(h, y + radius + 1)
    x0, x1 = max(0, x - radius), min(w, x + radius + 1)
    if y0 < y1 and x0 < x1:
        img[y0:y1, x0:x1] = color


def draw_detections(
    image: np.ndarray, results: List[dict], boxes: Sequence[tuple] = ()
) -> np.ndarray:
    """Render bboxes, raw keypoints, and PnP-reprojected cuboids."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8).copy())
    h, w = img.shape[:2]

    for i, det in enumerate(results):
        color = _COLORS[i % len(_COLORS)]
        bbox = np.asarray(det["bbox"], np.float64)
        _draw_line(img, bbox[[0, 1]], bbox[[2, 1]], color, 1)
        _draw_line(img, bbox[[2, 1]], bbox[[2, 3]], color, 1)
        _draw_line(img, bbox[[2, 3]], bbox[[0, 3]], color, 1)
        _draw_line(img, bbox[[0, 3]], bbox[[0, 1]], color, 1)
        kps = np.asarray(det["kps"], np.float64).reshape(-1, 2)
        for p in kps:
            _draw_point(img, p, color, 2)

    for i, box in enumerate(boxes):
        color = _COLORS[i % len(_COLORS)]
        proj9 = np.asarray(box[0], np.float64).copy()
        proj9[:, 0] *= w
        proj9[:, 1] *= h
        corners = proj9[1:]
        for a, b in CUBOID_EDGES:
            _draw_line(img, corners[a], corners[b], color, 2)
        _draw_point(img, proj9[0], (255, 255, 255), 3)
    return img


def overlay_heatmap(image: np.ndarray, heatmap: np.ndarray, alpha=0.5) -> np.ndarray:
    """Blend a [h, w] (or [h, w, J]) heatmap onto the image — the Debugger's
    `gen_colormap`/`add_blend_img` views (debugger.py)."""
    img = np.asarray(image, np.float64).copy()
    hm = np.asarray(heatmap, np.float64)
    if hm.ndim == 3:
        hm = hm.max(axis=-1)
    if hm.shape != img.shape[:2]:
        ry = img.shape[0] / hm.shape[0]
        rx = img.shape[1] / hm.shape[1]
        yy = (np.arange(img.shape[0]) / ry).astype(int).clip(0, hm.shape[0] - 1)
        xx = (np.arange(img.shape[1]) / rx).astype(int).clip(0, hm.shape[1] - 1)
        hm = hm[yy][:, xx]
    heat_rgb = np.stack([hm * 255, hm * 64, (1 - hm) * 128], axis=-1)
    out = img * (1 - alpha * hm[..., None]) + heat_rgb * alpha * hm[..., None]
    return out.clip(0, 255).astype(np.uint8)


def draw_tracking_arrows(image: np.ndarray, results) -> np.ndarray:
    """Arrows from each detection's center to its previous-frame position
    (ct + tracking offset) — the Debugger's tracking view (debugger.py arrows)."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8).copy())
    for i, det in enumerate(results):
        if "tracking" not in det:
            continue
        color = _COLORS[i % len(_COLORS)]
        ct = np.asarray(det["ct"], np.float64)
        prev = ct + np.asarray(det["tracking"], np.float64)
        _draw_line(img, ct, prev, color, 2)
        _draw_point(img, prev, color, 3)
        _draw_point(img, ct, (255, 255, 255), 2)
    return img


def draw_axes(
    image: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    camera: np.ndarray,
    length: float = 0.1,
) -> np.ndarray:
    """Project and draw the object's XYZ axes (debugger.py `add_axes` /
    eval_utils.py draw_axes)."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8).copy())
    origin = np.asarray(translation, np.float64)
    pts3d = np.vstack(
        [origin]
        + [origin + np.asarray(rotation) @ (np.eye(3)[i] * length) for i in range(3)]
    )
    z = np.where(np.abs(pts3d[:, 2]) < 1e-9, 1e-9, pts3d[:, 2])
    uv = np.stack(
        [
            camera[0, 0] * pts3d[:, 0] / z + camera[0, 2],
            camera[1, 1] * pts3d[:, 1] / z + camera[1, 2],
        ],
        axis=-1,
    )
    axis_colors = [(219, 68, 55), (15, 157, 88), (66, 133, 244)]  # x, y, z
    for i in range(3):
        _draw_line(img, uv[0], uv[i + 1], axis_colors[i], 2)
    return img
