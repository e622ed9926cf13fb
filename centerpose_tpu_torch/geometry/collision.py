"""Line-segment vs box intersection tests, the PyTorch package's copy of
`centerpose_tpu/geometry/collision.py` (numpy on the host).

Parity target: `CheckLineBox` (data/bbox_collision_detection.py), used in
offline preprocessing to label keypoint visibility (a keypoint is occluded
when the camera ray to it crosses another object's box). A slab test, as
the JAX package's, in place of the reference's per-face edge walk.
"""

from __future__ import annotations

import numpy as np


def segment_intersects_box(
    p0: np.ndarray, p1: np.ndarray, box_min: np.ndarray, box_max: np.ndarray
) -> bool:
    """True iff segment p0→p1 intersects the AABB [box_min, box_max] (slab test)."""
    p0 = np.asarray(p0, np.float64)
    d = np.asarray(p1, np.float64) - p0
    t_min, t_max = 0.0, 1.0
    for axis in range(3):
        if abs(d[axis]) < 1e-12:
            if p0[axis] < box_min[axis] or p0[axis] > box_max[axis]:
                return False
            continue
        inv = 1.0 / d[axis]
        t0 = (box_min[axis] - p0[axis]) * inv
        t1 = (box_max[axis] - p0[axis]) * inv
        if t0 > t1:
            t0, t1 = t1, t0
        t_min = max(t_min, t0)
        t_max = min(t_max, t1)
        if t_min > t_max:
            return False
    return True


def segment_intersects_oriented_box(
    p0, p1, rotation: np.ndarray, translation: np.ndarray, scale: np.ndarray
) -> bool:
    """Segment vs ORIENTED box: transform into the box frame, then slab test."""
    r = np.asarray(rotation, np.float64)
    t = np.asarray(translation, np.float64)
    half = np.asarray(scale, np.float64) / 2.0
    q0 = r.T @ (np.asarray(p0, np.float64) - t)
    q1 = r.T @ (np.asarray(p1, np.float64) - t)
    return segment_intersects_box(q0, q1, -half, half)
