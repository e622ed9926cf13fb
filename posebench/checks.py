"""The comparisons that decide `correct`: what the timed path produced,
against the plain reference on the same inputs.

Detections (`compare_boxes`). Each served box is read against the reference
at the cell it came from (`reference/serve.py::forced`), the way a served
token is read against the reference's logits, so that a box that rounding
moves to a neighbouring cell of a near-tie counts by the tie's width:

- `missing_boxes`: boxes one side has and the other has not (an image with
  no answer misses all of the reference's), summed over the sample; exact;
- `score_gap_mean`: the mean over the served boxes of |served score - the
  reference's score at that cell|;
- `kps_gap_px`: the largest gap of a served box's centre and 8 keypoints
  (displacement, and after the keypoint-heatmap blend) from the reference's
  at that cell, in image pixels;
- `scale_gap`: the largest gap of a served box's scale from the reference's
  at that cell, over the reference's largest component;
- `pose_gap_px`: the largest gap of a served box's reprojected cuboid from
  the reference's PnP of the box's own served keypoints and scale (PnP on
  its own), in image pixels (a pose on one side only: `NO_POSE`).

Worked out beside them and not limited: `score_gap`, the largest score gap;
and how far decode's choice of cell falls short in the reference's scores,
per box the largest of, at the box's cell, the reference's best score in its
3x3 neighbourhood over its score there (a cell that is no peak), its K-th
best peak's score over it (a peak not among the K best) and `vis_thresh`
over it, or 0: `choice_gap_mean` over the served boxes, `choice_gap` the
largest. On these random weights the top peaks lie within rounding of each
other, so a decode that picks the next-best peaks reads as sound runs do
(PERF.md, §2).

Each limited number is reported beside its limit; `correct` is every number
within its limit."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from posebench.reference import serve as refserve
from posebench.reference.serve import Box

NO_POSE = 1e6


def compare_boxes(prog: Sequence[Optional[List[Box]]], ref: Sequence[refserve.RefImage], vis_thresh: float,
                  hm_hp_thresh: float, frame_hw, out_res: int, device) -> Dict[str, float]:
    """The numbers of `prog` (the served boxes of each image, None for no
    answer) against the reference's readings `ref` of the same images."""
    if any(r.hm_hp_max > hm_hp_thresh for r in ref):
        raise RuntimeError("the reference found keypoint-heatmap peaks; the forced comparison reads "
                           "displacement keypoints only (the weights' hm_hp bias keeps them away)")
    missing = 0
    kps = scale = 0.0
    scores, choices = [], []                      # each box's score gap and choice gap
    served = []
    for p_boxes, r in zip(prog, ref):
        if p_boxes is None:
            missing += len(r.boxes)
            continue
        missing += abs(len(p_boxes) - len(r.boxes))
        for p in p_boxes:
            (y, x), s_ref, centre, disp, r_scale = refserve.forced(r, p.ct, frame_hw, out_res)
            peak = r.heat[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].max()
            scores.append(abs(p.score - s_ref))
            choices.append(max(0.0, peak - s_ref, r.kth_score - s_ref, vis_thresh - s_ref))
            kps = max(kps, np.abs(p.ct - centre).max(), np.abs(p.disp - disp).max(), np.abs(p.kps - disp).max())
            scale = max(scale, (np.abs(p.scale - r_scale) / np.abs(r_scale).max()).max())
            served.append(p)
    pose = 0.0
    if served:
        own = refserve.solve([p.disp for p in served], [p.scale for p in served], device)
        pose = max(_pose_gap(p.projected, q) for p, q in zip(served, own))
    return {"missing_boxes": float(missing), "score_gap_mean": float(np.mean(scores)) if scores else 0.0,
            "choice_gap_mean": float(np.mean(choices)) if choices else 0.0,
            "score_gap": float(max(scores, default=0.0)), "choice_gap": float(max(choices, default=0.0)),
            "kps_gap_px": float(kps), "scale_gap": float(scale), "pose_gap_px": float(pose)}


def _pose_gap(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> float:
    if (a is None) != (b is None):
        return NO_POSE
    return 0.0 if a is None else float(np.abs(a - b).max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """[{name, value, limit, ok}] for every limited number, in the limits'
    order; a number that is missing or not finite fails."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name)
        v = None if v is None else float(v)
        ok = v is not None and np.isfinite(v) and v <= limit
        out.append({"name": name, "value": v, "limit": limit, "ok": bool(ok)})
    return out
