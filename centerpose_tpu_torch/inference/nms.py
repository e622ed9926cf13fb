"""Soft-NMS over decoded detections (host-side, post-threshold).

Parity target: `soft_nms_nvidia` (src/lib/detectors/object_pose.py:27-124) as used by
`merge_outputs` (:184-197): gaussian method, weight = exp(-iou^2 / sigma), +1-pixel
box areas, survivors are boxes whose decayed score stays >= threshold. The reference
mutates a list of dicts with swap-to-front selection; this is the same greedy order
expressed over arrays.

The PyTorch package's own copy of `centerpose_tpu/inference/nms.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


def soft_nms(
    bboxes: np.ndarray,
    scores: np.ndarray,
    sigma: float = 0.5,
    nt: float = 0.5,
    threshold: float = 0.001,
    method: int = 2,
) -> np.ndarray:
    """Returns indices (into the input order) of surviving boxes, in greedy order.

    Args:
      bboxes: [N, 4] (x1, y1, x2, y2).
      scores: [N].
    """
    n = len(scores)
    scores = scores.astype(np.float64).copy()
    alive = np.ones(n, dtype=bool)
    processed = np.zeros(n, dtype=bool)
    order = []

    areas = (bboxes[:, 2] - bboxes[:, 0] + 1) * (bboxes[:, 3] - bboxes[:, 1] + 1)

    for _ in range(n):
        cand = alive & ~processed
        if not cand.any():
            break
        i = int(np.argmax(np.where(cand, scores, -np.inf)))
        processed[i] = True
        order.append(i)

        rest = alive & ~processed
        if not rest.any():
            continue
        ix1 = np.maximum(bboxes[i, 0], bboxes[:, 0])
        iy1 = np.maximum(bboxes[i, 1], bboxes[:, 1])
        ix2 = np.minimum(bboxes[i, 2], bboxes[:, 2])
        iy2 = np.minimum(bboxes[i, 3], bboxes[:, 3])
        iw = np.maximum(ix2 - ix1 + 1, 0)
        ih = np.maximum(iy2 - iy1 + 1, 0)
        inter = iw * ih
        iou = inter / (areas[i] + areas - inter)

        if method == 1:  # linear
            weight = np.where(iou > nt, 1 - iou, 1.0)
        elif method == 2:  # gaussian
            weight = np.exp(-(iou * iou) / sigma)
        else:  # hard NMS
            weight = np.where(iou > nt, 0.0, 1.0)

        scores = np.where(rest, scores * weight, scores)
        killed = rest & (scores < threshold)
        alive &= ~killed

    return np.array(order, dtype=np.int64)
