"""The comparisons that decide the tracking cell's `correct`: what
`Detector.run` and its tracker produced at a checked frame, against the
plain reference stepped from the state that frame started from
(`reference/track.py`).

`kept_state(tracker)` copies the tracker's tracks and id count into the
reference's plain form; `program_frame(out, tracker)` copies what a frame's
`run` returned. Both are taken inside the timed window, at the checked
frames only; `frame_load` counts a frame's matched and started tracks, at
every window frame. `compare(frames, frame_hw)` reads, over the checked frames:

- `missing_boxes` (exact): detections that reached the tracker on one side
  only (the reference's own count at its K best peaks against the program's
  tracks born or matched in the frame), and final boxes on one side only;
- `track_id_mismatch` (exact): track ids on one side only, paired tracks
  whose age or activity differ, and the difference of the id counts;
- `score_gap_mean`: the mean over the frame's detections of |score gap|;
- `kps_gap_px`: the largest gap of a detection's centre, tracking offset,
  and keypoints (displacement, after the heatmap blend, fused), image px;
- `kf_kps_gap_px`: the largest gap of a track's Kalman-filtered keypoints
  and their std, image px (a keypoint kept on one side only: `NO_POSE`);
- `scale_gap`: the largest gap of a track's pooled scale (and a
  detection's scale), over the reference's largest component;
- `pose_gap_px`: the largest gap of a track's re-PnP projected cuboid, on
  rows with 6 valid points or more, image px (a pose on one side only:
  `NO_POSE`);
- `fit_excess_px`: on rows with 4-5 valid points, whose pose is not unique,
  how far the program's mean reprojection error over the row's points
  exceeds the reference's (0 without such rows).

Worked out beside them and not limited: `rows_4_5_share` (the share of
re-PnP rows with 4-5 valid points), `choice_gap_mean` / `choice_gap`
(serving's: how far the program's choice of cell falls short in the
reference's scores), `score_gap` (the largest), `tracks_checked`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from posebench.reference import track as reftrack

NO_POSE = 1e6


def _arr(v) -> Optional[np.ndarray]:
    return None if v is None else np.array(v, np.float64)


def kept_state(tracker) -> reftrack.State:
    """The reference's copy of the state `tracker` (the port's) is in."""
    tracks = []
    for t in tracker.tracks:
        rec = {k: _arr(t[k]) for k in ("ct", "bbox", "kps", "kps_heatmap_std", "obj_scale",
                                      "obj_scale_uncertainty")}
        rec.update(tracking_id=int(t["tracking_id"]), age=int(t["age"]), active=int(t.get("active", 0)),
                   cls=int(t["cls"]), score=float(t["score"]),
                   scale_pool=[(_arr(m), _arr(u)) for m, u in t.get("scale_pool", [])],
                   kps_pnp_kf=_arr(t.get("kps_pnp_kf")), kps_mean_kf=_arr(t.get("kps_mean_kf")))
        if "kf" in t:
            rec["kf"] = (t["kf"].x.copy(), t["kf"].p.copy())
        tracks.append(rec)
    return reftrack.State(tracks=tracks, id_count=int(tracker.id_count))


def program_frame(out: dict, tracker) -> dict:
    """A copy of what the program's `run` gave for one frame."""
    tracks = []
    for t in out["results"]:
        rec = {k: _arr(t.get(k)) for k in ("ct", "kps", "kps_displacement_mean", "kps_fusion_mean", "tracking",
                                          "kps_mean_kf", "kps_std_kf", "obj_scale", "obj_scale_kf",
                                          "kps_pnp_kf")}
        rec.update(tracking_id=int(t["tracking_id"]), age=int(t["age"]), active=int(t.get("active", 0)),
                   score=float(t["score"]))
        tracks.append(rec)
    return {"tracks": tracks, "boxes": [int(b[4]["tracking_id"]) for b in out["boxes"]],
            "id_count": int(tracker.id_count)}


def frame_load(out: dict, ids_before: int, ids_after: int) -> Tuple[int, int]:
    """(matched, started): the tracks a frame's `run` matched (age 1, an
    id it had before the frame) and those it started."""
    matched = sum(1 for t in out["results"] if t["age"] == 1 and t["tracking_id"] <= ids_before)
    return matched, ids_after - ids_before


def cells_of(prog: dict) -> List[np.ndarray]:
    """The centres of the program's detections of the frame (the tracks
    born or matched in it, age 1), in its order."""
    return [t["ct"] for t in prog["tracks"] if t["age"] == 1]


def _gap(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is None and b is None else NO_POSE
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0


def _valid(kps) -> np.ndarray:
    return np.asarray(kps, np.float64).reshape(-1, 2)[:, 0] > -5000


def _fit(p9, kps, frame_hw) -> float:
    """Mean distance (px) of the valid keypoints from the projection `p9`."""
    proj = np.asarray(p9, np.float64)[1:] * [frame_hw[1], frame_hw[0]]
    pts = np.asarray(kps, np.float64).reshape(-1, 2)
    ok = _valid(pts)
    return float(np.linalg.norm(proj[ok] - pts[ok], axis=1).mean()) if ok.any() else 0.0


def compare(frames, frame_hw) -> Dict[str, float]:
    """`frames`: [(program_frame, reference `Frame`)] of the checked frames."""
    missing = mismatch = 0
    scores, choices = [], []
    kps = kf = scale = pose = excess = 0.0
    rows = rows_4_5 = paired = 0
    size = np.array([frame_hw[1], frame_hw[0]], np.float64)
    for prog, ref in frames:
        p_dets = [t for t in prog["tracks"] if t["age"] == 1]
        missing += abs(ref.own_dets - len(p_dets)) + abs(len(ref.boxes) - len(prog["boxes"]))
        p_by, r_by = {t["tracking_id"]: t for t in prog["tracks"]}, {t["tracking_id"]: t for t in ref.state.tracks}
        mismatch += len(set(p_by) ^ set(r_by)) + abs(prog["id_count"] - ref.state.id_count)
        mismatch += len(set(prog["boxes"]) ^ {t["tracking_id"] for t in ref.boxes})
        choices.extend(ref.choice_gaps)
        for tid in set(p_by) & set(r_by):
            p, r = p_by[tid], r_by[tid]
            paired += 1
            mismatch += int(p["age"] != r["age"] or p["active"] != r["active"])
            if r["age"] == 1:
                scores.append(abs(p["score"] - r["score"]))
                kps = max(kps, _gap(p["ct"], r["ct"]), _gap(p["tracking"], r["tracking"]),
                          _gap(p["kps"], r["kps"]), _gap(p["kps_displacement_mean"], r["kps_displacement_mean"]),
                          _gap(p["kps_fusion_mean"], r["kps_fusion_mean"]))
                scale = max(scale, _gap(p["obj_scale"], r["obj_scale"]) / np.abs(r["obj_scale"]).max())
            r_kf = r.get("kps_mean_kf")
            if r_kf is not None and p["kps_mean_kf"] is not None:
                if np.any(_valid(p["kps_mean_kf"]) != _valid(r_kf)):
                    kf = NO_POSE
                else:
                    ok = np.repeat(_valid(r_kf), 2)
                    kf = max(kf, _gap(np.asarray(p["kps_mean_kf"]).reshape(-1)[ok], np.asarray(r_kf).reshape(-1)[ok]),
                             _gap(p["kps_std_kf"], r["kps_std_kf"]))
            elif (r_kf is None) != (p["kps_mean_kf"] is None):
                kf = NO_POSE
            scale = max(scale, _gap(p["obj_scale_kf"], r["obj_scale_kf"]) / np.abs(r["obj_scale_kf"]).max())
            n_valid = r["valid_points"]
            rows += 1
            p_pose, r_pose = p["kps_pnp_kf"], r.get("kps_pnp_kf")
            if n_valid >= 6:
                pose = max(pose, NO_POSE if (p_pose is None) != (r_pose is None) else
                           0.0 if p_pose is None else float((np.abs(p_pose[1:] - r_pose[1:]) * size).max()))
            elif n_valid >= 4:
                rows_4_5 += 1
                if (p_pose is None) != (r_pose is None):
                    excess = NO_POSE
                elif p_pose is not None:
                    excess = max(excess, _fit(p_pose, p["kps_mean_kf"], frame_hw) - _fit(r_pose, r_kf, frame_hw))
    return {"missing_boxes": float(missing), "track_id_mismatch": float(mismatch),
            "score_gap_mean": float(np.mean(scores)) if scores else 0.0,
            "kps_gap_px": float(kps), "kf_kps_gap_px": float(kf), "scale_gap": float(scale),
            "pose_gap_px": float(pose), "fit_excess_px": float(max(excess, 0.0)),
            "rows_4_5_share": rows_4_5 / rows if rows else 0.0,
            "choice_gap_mean": float(np.mean(choices)) if choices else 0.0,
            "choice_gap": float(max(choices, default=0.0)), "score_gap": float(max(scores, default=0.0)),
            "tracks_checked": float(paired)}
