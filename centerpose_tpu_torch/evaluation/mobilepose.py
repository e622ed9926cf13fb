"""MobilePose-style EPnP lifting of detected 2D corners to up-to-scale 3D.

Parity target: `Evaluator.Lift2DTo3D` (src/tools/objectron_eval/
eval_image_official.py:805-862) — the published-comparison lever
`--eval_MobilePose_postprocessing`: instead of the PnP pose, the 8 detected 2D
corners are lifted directly to an up-to-scale 3D box whose projections hit
them exactly, constrained to the canonical-box barycentrics (the Objectron /
MobilePose `epnp_alpha_` matrix). Metric scale is recovered downstream from
the ground plane like every other eval path.

EPNP_ALPHA is the algorithm's own constant (the barycentric coordinates of the
8 unit-box corners w.r.t. its 4 EPnP control points; eval_image_official.py:
95-98) — identical by necessity.

The PyTorch package's copy of `centerpose_tpu/evaluation/mobilepose.py`.
"""

from __future__ import annotations

import numpy as np

EPNP_ALPHA = np.array(
    [4.0, -1.0, -1.0, -1.0, 2.0, -1.0, -1.0, 1.0, 2.0,
     -1.0, 1.0, -1.0, 0.0, -1.0, 1.0, 1.0, 2.0, 1.0, -1.0, -1.0,
     0.0, 1.0, -1.0, 1.0, 0.0, 1.0, 1.0, -1.0, -2.0, 1.0, 1.0, 1.0]
).reshape(8, 4)

# OpenCV→OpenGL frame conversion used throughout the repo's PnP outputs
# (cuboid_pnp_solver.py:184-189 parity; see ops/pnp.py _GL_SWAP).
_GL_SWAP = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])


def lift_2d_to_3d(
    kps_px: np.ndarray, camera_matrix: np.ndarray, width: int, height: int
):
    """Lift 8 detected corner pixels to (proj9_norm, pts3d_gl).

    Solves the 16x12 EPnP system: each corner constrains its camera-frame 3D
    point (expressed via EPNP_ALPHA in 4 control points) to its pixel ray; the
    smallest eigenvector of MᵀM is the up-to-scale solution. Returns the 9-pt
    normalized reprojections and 9-pt 3D corners in the repo's OpenGL camera
    frame (center first), drop-in replacements for the pnp_shell quintuple's
    first two entries.
    """
    kps = np.asarray(kps_px, np.float64).reshape(8, 2)
    cam = np.asarray(camera_matrix, np.float64)
    fx, fy = cam[0, 0], cam[1, 1]
    cx, cy = cam[0, 2], cam[1, 2]

    m = np.zeros((16, 12))
    for i in range(8):
        px, py = kps[i]
        for j in range(4):
            a = EPNP_ALPHA[i, j]
            # Ray constraints in the OpenCV pinhole (z > 0 forward):
            #   fx·Xj + (cx − px)·Zj = 0,   fy·Yj + (cy − py)·Zj = 0
            m[2 * i, 3 * j] = fx * a
            m[2 * i, 3 * j + 2] = (cx - px) * a
            m[2 * i + 1, 3 * j + 1] = fy * a
            m[2 * i + 1, 3 * j + 2] = (cy - py) * a

    _, vecs = np.linalg.eigh(m.T @ m)
    ctrl = vecs[:, 0].reshape(4, 3)
    verts = EPNP_ALPHA @ ctrl                     # [8, 3] camera frame (CV)
    if verts[:, 2].mean() < 0:                    # box must sit in front
        ctrl = -ctrl
        verts = -verts

    pts3d_cv = np.vstack([ctrl[0:1], verts])      # center first (ref :840-850)

    z = np.where(np.abs(pts3d_cv[:, 2]) < 1e-12, 1e-12, pts3d_cv[:, 2])
    proj9 = np.stack(
        [
            (fx * pts3d_cv[:, 0] / z + cx) / float(width),
            (fy * pts3d_cv[:, 1] / z + cy) / float(height),
        ],
        axis=-1,
    )
    pts3d_gl = pts3d_cv @ _GL_SWAP.T
    return proj9, pts3d_gl
