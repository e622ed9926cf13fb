"""Hit/Miss accumulation and confidence-ranked average precision.

Parity targets:
  * `HitMiss` over 21 linspace thresholds per metric family
    (src/tools/objectron_eval/eval_image_official.py:59-64,145-160);
  * confidence-ranked AP (`metrics_nvidia.py:32-137`): hit/miss pairs recorded with
    their confidence, sorted descending, cumulative precision/recall, VOC-style
    all-points interpolation (precision envelope, sum over recall steps);
  * viewpoint (azimuth/polar), ADD/ADD-S, scale and 2D-pixel error definitions
    (eval_image_official.py:664-994).

The PyTorch package's copy of `centerpose_tpu/evaluation/metrics.py`: float64
numpy on the host, as there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_NUM_BINS = 21

# Metric-family threshold ranges (eval_image_official.py:59-64).
THRESH_3D_IOU = np.linspace(0.0, 1.0, DEFAULT_NUM_BINS)
THRESH_2D_PIXEL = np.linspace(0.0, 0.1, DEFAULT_NUM_BINS)
THRESH_AZIMUTH = np.linspace(0.0, 30.0, DEFAULT_NUM_BINS)
THRESH_POLAR = np.linspace(0.0, 20.0, DEFAULT_NUM_BINS)
THRESH_ADD = np.linspace(0.0, 1.0, DEFAULT_NUM_BINS)
THRESH_SCALE = np.linspace(0.0, 1.0, DEFAULT_NUM_BINS)


class HitMiss:
    """Per-threshold (hit, confidence) records for one metric family.

    `record_hit_miss(metric, conf)`: for error-type metrics, pass
    `greater=False` so a hit is metric <= threshold; for IoU-type, hit is
    metric >= threshold.
    """

    def __init__(self, thresholds: np.ndarray):
        self.thresholds = np.asarray(thresholds, np.float64)
        self.records: List[List[Tuple[float, float]]] = [
            [] for _ in self.thresholds
        ]

    def record_hit_miss(self, metric: float, conf: float = 1.0, greater: bool = True):
        for i, t in enumerate(self.thresholds):
            hit = metric >= t if greater else metric <= t
            self.records[i].append((1.0 if hit else 0.0, float(conf)))


class AveragePrecision:
    """Confidence-ranked AP accumulation over a HitMiss family
    (metrics_nvidia.py semantics).

    Parity quirk, kept deliberately: the greedy matcher is not one-to-one
    (eval_image_official.py:1076-1096 matches every prediction to its nearest
    GT), so with num_pred > num_gt duplicate hits can push recall — and hence
    AP — above 1.0. The reference behaves identically: metrics_nvidia.py:80-101
    appends a terminal (recall=1.0, precision=0.0) point whose envelope
    contribution is zero, retaining the overflow area, exactly like the
    `[recall[-1]]` terminal here. Tracker-heavy evals (more emitted tracks
    than GT objects) surface it; detector evals with score thresholds rarely
    do."""

    def __init__(self, num_gt: int = 0):
        self.num_gt = num_gt
        self.aps: Optional[np.ndarray] = None

    @staticmethod
    def _ap_from_records(
        records: Sequence[Tuple[float, float]], num_gt: int
    ) -> float:
        if not records or num_gt <= 0:
            return 0.0
        arr = np.asarray(records, np.float64)
        order = np.argsort(-arr[:, 1], kind="stable")
        hits = arr[order, 0]
        tp = np.cumsum(hits)
        fp = np.cumsum(1.0 - hits)
        recall = tp / num_gt
        precision = tp / np.maximum(tp + fp, 1e-12)

        # VOC all-points interpolation: precision envelope integrated over recall.
        mrec = np.concatenate([[0.0], recall, [recall[-1]]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def compute(self, hitmiss: HitMiss) -> np.ndarray:
        self.aps = np.array(
            [self._ap_from_records(r, self.num_gt) for r in hitmiss.records]
        )
        return self.aps

    def at_threshold(self, hitmiss: HitMiss, thresh_value: float) -> float:
        aps = self.compute(hitmiss)
        i = int(np.argmin(np.abs(hitmiss.thresholds - thresh_value)))
        return float(aps[i])


# ------------------------------------------------------------------ metric defs
def scale_error(scale_pred, scale_gt) -> float:
    """Relative scale error after height normalization
    (eval_image_official.py:664-671): SUM of |Δs| / s_gt over the 3 dims with both
    scales normalized by their y component (the reference uses np.sum, not a
    mean — the 21 linspace(0,1) thresholds are calibrated to the summed error)."""
    p = np.asarray(scale_pred, np.float64)
    g = np.asarray(scale_gt, np.float64)
    p = p / p[1]
    g = g / g[1]
    return float(np.sum(np.abs(p - g) / g))


def _rotation_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def fit_projection(kps_3d: np.ndarray, kps_2d: np.ndarray) -> np.ndarray:
    """DLT fit of the 3x4 projection mapping camera-frame 3D points to normalized
    2D image coords (homogeneous least squares over the 9 box keypoints).

    The reference's evaluate_2d (eval_image_official.py:673-719) reprojects the
    y-rotated GT box through the Objectron annotation's projection matrix; the
    repo's eval inputs carry only (kps_3d_cam, kps_2d_norm) pairs, from which the
    same pinhole projection is recovered exactly (9 non-coplanar points >= the 6
    DLT minimum), independent of axis/handedness conventions.
    """
    x = np.asarray(kps_3d, np.float64)
    u = np.asarray(kps_2d, np.float64)
    n = x.shape[0]
    xh = np.hstack([x, np.ones((n, 1))])
    rows = []
    for i in range(n):
        rows.append(np.concatenate([xh[i], np.zeros(4), -u[i, 0] * xh[i]]))
        rows.append(np.concatenate([np.zeros(4), xh[i], -u[i, 1] * xh[i]]))
    a = np.asarray(rows)
    _, _, vt = np.linalg.svd(a)
    return vt[-1].reshape(3, 4)


def _project(p: np.ndarray, kps_3d: np.ndarray) -> np.ndarray:
    xh = np.hstack([kps_3d, np.ones((kps_3d.shape[0], 1))])
    uvw = xh @ p.T
    return uvw[:, :2] / uvw[:, 2:3]


def pixel_error_2d(
    kps_pred: np.ndarray,
    kps_gt: np.ndarray,
    num_symmetry: int = 1,
    kps_gt_3d: Optional[np.ndarray] = None,
    Mo2c: Optional[np.ndarray] = None,
) -> float:
    """Mean normalized 2D corner distance with a symmetry sweep
    (eval_image_official.py:673-719).

    Parity notes: the reference (a) averages over the 8 CORNERS only (box[1:]),
    and (b) sweeps by rotating the GT 3D box about its local y axis in steps of
    2π/num_symmetry and REPROJECTING (proj @ Mo2c @ M_R @ Mc2o) — a corner-label
    permutation is only equivalent for 90° steps on square-footprint boxes. When
    (kps_gt_3d, Mo2c) are given, the reprojection sweep is used with the
    projection recovered by `fit_projection`; otherwise falls back to the 90°
    corner-relabeling sweep (valid for num_symmetry in {2, 4} on square boxes).
    Both inputs are [9, 2] normalized (center first, corners in binary order).
    """
    pred = np.asarray(kps_pred, np.float64)
    gt = np.asarray(kps_gt, np.float64)
    if num_symmetry <= 1:
        return float(np.mean(np.linalg.norm(pred[1:] - gt[1:], axis=1)))

    if kps_gt_3d is not None and Mo2c is not None:
        x3d = np.asarray(kps_gt_3d, np.float64)
        proj = fit_projection(x3d, gt)
        mo2c = np.asarray(Mo2c, np.float64)
        mc2o = np.linalg.inv(mo2c)
        best = np.inf
        xh = np.hstack([x3d, np.ones((x3d.shape[0], 1))])
        for i in range(num_symmetry):
            m_r = np.eye(4)
            m_r[:3, :3] = _rotation_y(2.0 * np.pi * i / num_symmetry)
            rotated = (xh @ (mo2c @ m_r @ mc2o).T)[:, :3]
            gt_rot = _project(proj, rotated)
            err = float(np.mean(np.linalg.norm(pred[1:] - gt_rot[1:], axis=1)))
            best = min(best, err)
        return best

    # Fallback: relabel corners through the 90° y-rotation 4-cycles. In the
    # 9-pt binary corner order (1..8 = sign bits of x, y, z; y up), a +90°
    # rotation about y cycles the y=- ring 1→2→6→5 and the y=+ ring 3→4→8→7.
    best = np.inf
    bottom = [1, 2, 6, 5]
    top = [3, 4, 8, 7]
    for k in range(4):
        perm = np.arange(9)
        for src, dst in zip(bottom, np.roll(bottom, -k)):
            perm[src] = dst
        for src, dst in zip(top, np.roll(top, -k)):
            perm[src] = dst
        err = float(np.mean(np.linalg.norm(pred[1:] - gt[perm][1:], axis=1)))
        best = min(best, err)
    return best


def viewpoint_angles(
    rotation: np.ndarray, translation: Optional[np.ndarray] = None
) -> Tuple[float, float]:
    """(azimuth, polar) of the CAMERA POSITION in the object frame, degrees
    (eval_image_official.py compute_ray/compute_viewpoint: the fitted box→object
    transform's translation column is the camera origin in object coordinates,
    i.e. -Rᵀt; azimuth = atan2(z, x) ∈ (-180, 180], polar = elevation
    atan2(y, hypot(x, z)))."""
    r = np.asarray(rotation, np.float64)
    if translation is None:
        # Degenerate fallback (no translation known): use the view direction.
        cam = -r.T @ np.array([0.0, 0.0, 1.0])
    else:
        cam = -r.T @ np.asarray(translation, np.float64)
    azimuth = np.degrees(np.arctan2(cam[2], cam[0]))
    polar = np.degrees(np.arctan2(cam[1], np.hypot(cam[0], cam[2])))
    return float(azimuth), float(polar)


def azimuth_polar_error(
    rot_pred: np.ndarray,
    rot_gt: np.ndarray,
    num_symmetry: int = 1,
    t_pred: Optional[np.ndarray] = None,
    t_gt: Optional[np.ndarray] = None,
) -> Tuple[float, float]:
    """Angular viewpoint errors (evaluate_viewpoint,
    eval_image_official.py:968-994): polar error is the plain |Δ|; azimuth error
    is folded with |Δ| % (360 / num_symmetry) (then mirrored above 180°) rather
    than a discrete rotation sweep — exact for any num_symmetry (the reference
    uses 100 for bottle/cup)."""
    az_p, po_p = viewpoint_angles(rot_pred, t_pred)
    az_g, po_g = viewpoint_angles(rot_gt, t_gt)
    n = max(1, int(num_symmetry))
    d_az = abs(az_p - az_g) % (360.0 / n)
    if d_az > 180.0:
        d_az = 360.0 - d_az
    return float(d_az), float(abs(po_p - po_g))


def add_metric(points_pred: np.ndarray, points_gt: np.ndarray) -> float:
    """ADD: mean 3D distance between corresponding points (meters)."""
    return float(
        np.mean(np.linalg.norm(np.asarray(points_pred) - np.asarray(points_gt), axis=1))
    )


def adds_metric(points_pred: np.ndarray, points_gt: np.ndarray) -> float:
    """ADD-S: mean closest-point 3D distance (symmetric objects)."""
    p = np.asarray(points_pred, np.float64)
    g = np.asarray(points_gt, np.float64)
    d = np.linalg.norm(p[:, None, :] - g[None, :, :], axis=2)
    return float(np.mean(d.min(axis=1)))
