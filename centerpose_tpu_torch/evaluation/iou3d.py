"""Exact oriented 3D box IoU via polygon clipping.

Parity target: the vendored Objectron metric library's `iou.py`
(src/tools/objectron_eval/objectron/dataset/iou.py:22-100): the intersection of two
oriented boxes is computed by Sutherland–Hodgman-clipping each box's faces against
the other box's halfspaces and taking the convex-hull volume of the surviving
points + mutually-contained corners; IoU = v_int / (v1 + v2 - v_int).

Implementation is from the algorithm itself (not a code port): clipping happens in
box1's object frame, where box1's halfspaces are axis-aligned — each of the 6 clip
planes is then a single coordinate comparison.

The PyTorch package's copy of `centerpose_tpu/evaluation/iou3d.py`. Both
entry points run the package's own C++ library (`native/iou3d.cpp`, built at
first use) unless `use_native=False` selects the numpy path below, which is
the plain version the library is held against. Unlike the JAX package, a
library that cannot be built raises instead of falling back to numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.native import iou3d_native, iou3d_sweep_native

try:
    from scipy.spatial import ConvexHull, QhullError
except ImportError:  # pragma: no cover
    from scipy.spatial import ConvexHull
    from scipy.spatial.qhull import QhullError

# Face corner indices in binary-counting corner order (x high bit, z low bit):
# each face fixes one axis at -/+ half-extent.
_FACES = (
    (0, 1, 3, 2),  # x = -sx/2
    (4, 6, 7, 5),  # x = +sx/2
    (0, 4, 5, 1),  # y = -sy/2
    (2, 3, 7, 6),  # y = +sy/2
    (0, 2, 6, 4),  # z = -sz/2
    (1, 5, 7, 3),  # z = +sz/2
)


@dataclasses.dataclass
class OrientedBox:
    """rotation [3,3], translation [3], scale [3] (full extents)."""

    rotation: np.ndarray
    translation: np.ndarray
    scale: np.ndarray

    @property
    def volume(self) -> float:
        return float(abs(np.prod(self.scale)))

    def corners(self) -> np.ndarray:
        """[8, 3] world-frame corners in binary-counting order."""
        local = cuboid_vertices(self.scale)
        return local @ self.rotation.T + self.translation

    def to_local(self, points: np.ndarray) -> np.ndarray:
        return (points - self.translation) @ self.rotation

    @classmethod
    def from_corners_fit(cls, corners: np.ndarray) -> "OrientedBox":
        """Least-squares fit of (R, t, s) to 8 corners in binary order (the
        objectron `box.py:10-43` fit-from-keypoints behavior)."""
        corners = np.asarray(corners, np.float64)
        t = corners.mean(axis=0)
        centered = corners - t
        unit = cuboid_vertices((1.0, 1.0, 1.0))  # +-0.5 cube
        # scale along each local axis from edge lengths via lstsq on the system
        # centered ≈ unit * s @ R^T  →  solve for M = diag(s) R^T.
        m, *_ = np.linalg.lstsq(unit, centered, rcond=None)
        # Polar decomposition: M^T = R diag(s) approx → SVD.
        u, sv, vt = np.linalg.svd(m.T)
        d = np.sign(np.linalg.det(u @ vt))
        r = u @ np.diag([1.0, 1.0, d]) @ vt
        s = np.diag(r.T @ m.T)  # extract per-axis scale
        return cls(rotation=r, translation=t, scale=np.abs(s))


def _clip_polygon_axis(poly: List[np.ndarray], axis: int, bound: float, keep_below: bool):
    """Clip a 3D polygon against plane coord[axis] == bound."""
    if not poly:
        return poly
    out: List[np.ndarray] = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        if keep_below:
            cur_in = cur[axis] <= bound
            nxt_in = nxt[axis] <= bound
        else:
            cur_in = cur[axis] >= bound
            nxt_in = nxt[axis] >= bound
        if cur_in:
            out.append(cur)
        if cur_in != nxt_in:
            denom = nxt[axis] - cur[axis]
            t = (bound - cur[axis]) / denom if abs(denom) > 1e-12 else 0.0
            out.append(cur + t * (nxt - cur))
    return out


def _inside(points: np.ndarray, half: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    return np.all(np.abs(points) <= half[None, :] + eps, axis=1)


def box_iou_3d(box1: OrientedBox, box2: OrientedBox, use_native: bool = True) -> float:
    """Exact IoU of two oriented 3D boxes.

    `use_native` runs the C++ library (`centerpose_tpu_torch/native`); the
    numpy path below is the plain version.
    """
    if use_native:
        return iou3d_native(
            box1.rotation, box1.translation, box1.scale,
            box2.rotation, box2.translation, box2.scale,
        )
    half1 = np.asarray(box1.scale, np.float64) / 2.0

    # Work in box1's object frame: box1 is axis-aligned [-half1, half1].
    corners2 = box1.to_local(box2.corners())

    points: List[np.ndarray] = []
    # Clip each face of box2 against box1's 6 axis-aligned halfspaces.
    for face in _FACES:
        poly = [corners2[i] for i in face]
        for axis in range(3):
            poly = _clip_polygon_axis(poly, axis, half1[axis], keep_below=True)
            poly = _clip_polygon_axis(poly, axis, -half1[axis], keep_below=False)
        points.extend(poly)

    # Corners of box1 inside box2 (checked in box2's frame).
    corners1_local = cuboid_vertices(box1.scale)
    corners1_world = box1.corners()
    half2 = np.asarray(box2.scale, np.float64) / 2.0
    in2 = _inside(box2.to_local(corners1_world), half2)
    points.extend(corners1_local[in2])

    if len(points) < 4:
        return 0.0
    pts = np.asarray(points)
    try:
        inter_vol = float(ConvexHull(pts).volume)
    except (QhullError, ValueError):
        return 0.0

    union = box1.volume + box2.volume - inter_vol
    if union <= 0:
        return 0.0
    return float(np.clip(inter_vol / union, 0.0, 1.0))


def iou_with_symmetry_sweep(
    box_pred: OrientedBox, box_gt: OrientedBox, num_rotations: int = 1,
    use_native: bool = True,
) -> float:
    """Max IoU over N rotations of the GT box about its local y axis — the
    symmetric-category rotation sweep (eval_image_official.py:739-793)."""
    if num_rotations <= 1:
        return box_iou_3d(box_pred, box_gt, use_native)
    if use_native:
        return iou3d_sweep_native(
            box_pred.rotation, box_pred.translation, box_pred.scale,
            box_gt.rotation, box_gt.translation, box_gt.scale, num_rotations,
        )
    best = 0.0
    for i in range(num_rotations):
        theta = 2.0 * np.pi * i / num_rotations
        c, s = np.cos(theta), np.sin(theta)
        ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        rotated = OrientedBox(
            rotation=box_gt.rotation @ ry,
            translation=box_gt.translation,
            scale=box_gt.scale,
        )
        best = max(best, box_iou_3d(box_pred, rotated, use_native=False))
    return best
