"""CenterPose + Kalman baseline tracker (the `--refined_Kalman` mode).

Counterpart of `centerpose_tpu/tracking/tracker_baseline.py`. Parity target: `Tracker_baseline` (src/lib/utils/tracker_baseline.py:14-310). Same
skeleton as the full tracker with three behavioral differences:
  * the Kalman filter observes positions only (dim_z=16, :55-77) — velocities are
    latent, never measured (there is no tracking_hp head in plain CenterPose);
  * association predicts each track's center with its mean KF velocity instead of
    using the detection's tracking offset (:134-140);
  * the scale pool is a plain running mean rather than inverse-variance fusion
    (:91-100).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.tracking.kalman import KeypointKalman
from centerpose_tpu_torch.tracking.tracker import Tracker


class TrackerBaseline(Tracker):
    def step(self, dets: List[dict], boxes: List[tuple], meta: Optional[dict] = None):
        # Detections carry no tracking offset in plain CenterPose.
        for det in dets:
            det.setdefault("tracking", np.zeros(2))
            det.setdefault("tracking_hp", np.zeros(16))
        return super().step(dets, boxes, meta)

    def _track_centers(self) -> np.ndarray:
        # Association predicts each track's center with its mean KF velocity
        # — computed LOCALLY for the distance matrix only
        # (tracker_baseline.py:134-140 `tracks_center`); track['ct'] itself
        # stays at the last detection, so an unmatched track does not
        # accumulate velocity drift across missed frames.
        centers = []
        for track in self.tracks:
            ct = np.asarray(track["ct"], np.float64)
            if "kf" in track:
                ct = ct + track["kf"].mean_velocity
            centers.append(ct)
        return np.array(centers, np.float32).reshape(len(self.tracks), 2)

    # --- overrides of the KF interaction points --------------------------------
    def _kf_init(self, det: dict) -> KeypointKalman:
        kf = KeypointKalman.init(
            np.asarray(det["kps_fusion_mean"]),
            np.asarray(det["kps_fusion_std"]),
            np.zeros(16),
            self.cfg.kf_r_velocity,
        )
        # The reference baseline leaves P0's velocity blocks at the filterpy
        # default (1), assigning only the x/y block (tracker_baseline.py:71 —
        # whose [[sx2, sy2]] broadcast also fills the off-diagonals; kept as
        # the proper diagonal here, deliberate fix).
        kf.p[:, 2, 2] = 1.0
        kf.p[:, 3, 3] = 1.0
        return kf

    def _kf_update(self, kf: KeypointKalman, det: dict) -> None:
        kf.update_positions(
            np.asarray(det["kps_fusion_mean"]), np.asarray(det["kps_fusion_std"])
        )

    def _pool(self, scale_pool):
        # Plain mean, zero pooled uncertainty (tracker_baseline.py:91-100
        # returns `mean, 0`).
        means = np.stack([np.asarray(m, np.float64) for m, _ in scale_pool])
        return means.mean(axis=0), np.zeros(3)
