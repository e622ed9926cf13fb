"""CenterPoseTrack tracker: association → Kalman → scale pool → re-PnP.

Parity target: `Tracker` (src/lib/utils/tracker.py:14-314):
  * greedy (or Hungarian) association on center+tracking-offset distance, gated by
    box area and class (:126-177);
  * matched tracks: KF predict + update with fused keypoint observations (:179-200);
  * unmatched dets above new_thresh spawn tracks (:202-218); unmatched tracks age out
    after max_age, assumed static meanwhile (:220-236);
  * Bayesian inverse-variance scale pooling (:98-110);
  * covariance-based per-keypoint confidence gating, low-conf keypoints dropped to
    -10000, PnP re-run on the filtered keypoints + pooled scale (:243-292).

Counterpart of `centerpose_tpu/tracking/tracker.py`. The Kalman math is the
vectorized block form in tracking/kalman.py (numpy, on the host); the re-PnP
runs batched on the device for all tracks at once, as ONE padded solve over
`cfg.max_tracks` slots (`ops/pnp.py::solve_pnp_batch`). The Hungarian solver
is scipy.optimize.linear_sum_assignment (same optimum as sklearn's deprecated
linear_assignment).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.ops.pnp import PnPResult, solve_pnp_batch
from centerpose_tpu_torch.tracking.kalman import KeypointKalman


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """tracker.py:305-314: row-order greedy matching under the 1e16 gate."""
    matched = []
    if dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    dist = dist.copy()
    for i in range(dist.shape[0]):
        jx = int(dist[i].argmin())
        if dist[i][jx] < 1e16:
            dist[:, jx] = 1e18
            matched.append([i, jx])
    return np.array(matched, np.int32).reshape(-1, 2)


def _pool_scale(scale_pool: List[Tuple[np.ndarray, np.ndarray]]):
    """Inverse-variance fusion over the track's history (tracker.py:98-110)."""
    prec = np.zeros(3)
    mean = np.zeros(3)
    for s_mean, s_unc in scale_pool:
        p = np.asarray(s_unc, np.float64) ** -2
        prec += p
        mean += p * np.asarray(s_mean, np.float64)
    std = prec ** -0.5
    return mean * std ** 2, std


class Tracker:
    """Track state across the frames of one video. The re-PnP runs on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: CenterPoseConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.meta: Optional[dict] = None
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: List[dict] = []

    def active_tracks(self) -> List[dict]:
        return self.tracks

    def init_track(self, meta: dict):
        """Seed tracks from externally provided pre_dets (tracker.py:21-49)."""
        self.meta = meta
        dets = meta.get("pre_dets")
        if dets is None:
            return
        self.reset()
        for item in dets:
            if item["score"] > self.cfg.new_thresh:
                self.id_count += 1
                item["active"] = 1
                item["age"] = 1
                item["tracking_id"] = self.id_count
                if "ct" not in item:
                    bbox = item["bbox"]
                    item["ct"] = [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2]
                if self.cfg.use_kalman and "kps_fusion_mean" in item:
                    item["kf"] = self._kf_init(item)
                if self.cfg.use_scale_pool:
                    item["scale_pool"] = [
                        (item["obj_scale"], item["obj_scale_uncertainty"])
                    ]
                self.tracks.append(item)

    # --- overridable filter hooks (TrackerBaseline swaps these) ----------------
    def _kf_init(self, det: dict) -> KeypointKalman:
        return KeypointKalman.init(
            np.asarray(det["kps_fusion_mean"]),
            np.asarray(det["kps_fusion_std"]),
            np.asarray(det["tracking_hp"]),
            self.cfg.kf_r_velocity,
        )

    def _kf_update(self, kf: KeypointKalman, det: dict) -> None:
        kf.update(
            np.asarray(det["kps_fusion_mean"]),
            np.asarray(det["kps_fusion_std"]),
            np.asarray(det["tracking_hp"]),
        )

    def _pool(self, scale_pool):
        return _pool_scale(scale_pool)

    def _track_centers(self) -> np.ndarray:
        """Track centers for the association distance matrix. The baseline
        tracker overrides this with KF-velocity-shifted centers computed
        LOCALLY (tracker_baseline.py:134-140 keeps track['ct'] itself static
        for unmatched tracks)."""
        return np.array(
            [t["ct"] for t in self.tracks], np.float32
        ).reshape(len(self.tracks), 2)

    # ------------------------------------------------------------------ step
    def step(self, dets: List[dict], boxes: List[tuple], meta: Optional[dict] = None):
        cfg = self.cfg
        if meta is not None:
            self.meta = meta

        # Step 0: when PnP ran, only PnP-surviving dets are tracked (tracker.py:115-123).
        if boxes:
            dets = []
            for box in boxes:
                det = box[4]
                det["kps_pnp"] = box[0]
                det["kps_3d_cam"] = box[1]
                det["kps_ori"] = box[3]
                dets.append(det)

        n, m = len(dets), len(self.tracks)

        # Step 1: association (tracker.py:126-177).
        dets_center = np.array(
            [np.asarray(d["ct"]) + np.asarray(d["tracking"]) for d in dets], np.float32
        ).reshape(n, 2)
        tracks_center = self._track_centers()
        track_size = np.array(
            [
                (t["bbox"][2] - t["bbox"][0]) * (t["bbox"][3] - t["bbox"][1])
                for t in self.tracks
            ],
            np.float32,
        )
        item_size = np.array(
            [(d["bbox"][2] - d["bbox"][0]) * (d["bbox"][3] - d["bbox"][1]) for d in dets],
            np.float32,
        )
        track_cat = np.array([t["cls"] for t in self.tracks], np.int32)
        item_cat = np.array([d["cls"] for d in dets], np.int32)

        dist = (
            (tracks_center.reshape(1, m, 2) - dets_center.reshape(n, 1, 2)) ** 2
        ).sum(axis=2)
        invalid = (
            (dist > track_size.reshape(1, m))
            | (dist > item_size.reshape(n, 1))
            | (item_cat.reshape(n, 1) != track_cat.reshape(1, m))
        )
        dist = dist + invalid * 1e18

        if cfg.use_hungarian:
            from scipy.optimize import linear_sum_assignment

            d2 = np.minimum(dist, 1e18)
            rows, cols = linear_sum_assignment(d2)
            matched_indices = np.stack([rows, cols], axis=1)
        else:
            matched_indices = greedy_assignment(dist)

        unmatched_dets = [d for d in range(n) if d not in matched_indices[:, 0]]
        unmatched_tracks = [d for d in range(m) if d not in matched_indices[:, 1]]

        if cfg.use_hungarian:
            matches = []
            for mi in matched_indices:
                if dist[mi[0], mi[1]] > 1e16:
                    unmatched_dets.append(mi[0])
                    unmatched_tracks.append(mi[1])
                else:
                    matches.append(mi)
            matches = np.array(matches).reshape(-1, 2)
        else:
            matches = matched_indices

        # Step 2: matched (tracker.py:179-200).
        ret = []
        for mi in matches:
            track = dets[mi[0]]
            prev = self.tracks[mi[1]]
            track["tracking_id"] = prev["tracking_id"]
            track["age"] = 1
            track["active"] = prev.get("active", 0) + 1
            if cfg.use_kalman and "kf" in prev:
                track["kf"] = prev["kf"]
                track["kf"].predict()
                self._kf_update(track["kf"], track)
            if cfg.use_scale_pool:
                track["scale_pool"] = prev["scale_pool"]
                track["scale_pool"].append(
                    (track["obj_scale"], track["obj_scale_uncertainty"])
                )
            ret.append(track)

        # Step 3: new tracks (tracker.py:202-218).
        for i in unmatched_dets:
            track = dets[i]
            if track["score"] > cfg.new_thresh:
                self.id_count += 1
                track["tracking_id"] = self.id_count
                track["age"] = 1
                track["active"] = 1
                if cfg.use_kalman and "kps_fusion_mean" in track:
                    track["kf"] = self._kf_init(track)
                if cfg.use_scale_pool:
                    track["scale_pool"] = [
                        (track["obj_scale"], track["obj_scale_uncertainty"])
                    ]
                ret.append(track)

        # Step 4: age unmatched tracks, assume static (tracker.py:220-236).
        for i in unmatched_tracks:
            track = self.tracks[i]
            if track["age"] < cfg.max_age:
                track["age"] += 1
                track["active"] = 0
                ret.append(track)

        if not (cfg.use_kalman or cfg.use_scale_pool):
            self.tracks = ret
            return ret, boxes

        # Steps 5-6: filtered keypoints + pooled scale → re-PnP (tracker.py:238-292).
        # ONE fixed-shape solve over cfg.max_tracks padded slots per frame
        # (a per-track solve would cost a round of launches and a fetch per
        # track).
        new_boxes = []
        pnp_inputs = []
        for track in ret:
            kps_mean_kf = np.asarray(track["kps"], np.float64).reshape(-1, 2)
            kps_conf = None
            if cfg.use_kalman and "kf" in track:
                kf: KeypointKalman = track["kf"]
                kps_mean_kf = kf.positions.astype(np.float64)
                track["kps_mean_kf"] = kps_mean_kf
                track["kps_std_kf"] = kf.position_std
                kps_conf = kf.confidence(cfg.conf_border)
                low = kps_conf < 0.15
                kps_mean_kf[low] = -10000.0

            scale_new = np.asarray(track["obj_scale"])
            if cfg.use_scale_pool and "scale_pool" in track:
                mean, std = self._pool(track["scale_pool"])
                track["obj_scale_kf"] = mean
                track["obj_scale_uncertainty_kf"] = std
                scale_new = mean
            pnp_inputs.append((track, kps_mean_kf, scale_new, kps_conf))

        results = self._re_pnp_batch(pnp_inputs[: cfg.max_tracks])
        for (track, _, scale_new, kps_conf), ret_pnp in zip(pnp_inputs, results):
            if ret_pnp is None:
                continue
            conf_avg = float(np.sum(kps_conf) / 8) if kps_conf is not None else 1.0
            if conf_avg > 0.25:
                new_boxes.append(ret_pnp)
            track["kps_pnp_kf"] = ret_pnp[0]
            track["kps_3d_cam_kf"] = ret_pnp[1]
            track["kps_ori_kf"] = ret_pnp[3]

        if len(pnp_inputs) > cfg.max_tracks:
            # Tracks beyond the fixed device-solve slots keep their UNREFINED
            # PnP box from this frame (the reference has no cap; silently
            # dropping valid detections would hide them from eval and the
            # pre-heatmap render).
            print(
                f"WARNING: {len(pnp_inputs)} tracks exceed max_tracks="
                f"{cfg.max_tracks}; overflow boxes pass through un-refined",
                flush=True,
            )
            refine_input = {id(b[4]): b for b in boxes}
            for track, _, _, _ in pnp_inputs[cfg.max_tracks:]:
                box = refine_input.get(id(track))
                if box is not None:
                    new_boxes.append(box)

        self.tracks = ret
        return ret, new_boxes

    # ------------------------------------------------------------------ re-PnP
    def _re_pnp_batch(self, items):
        """pnp_shell on KF-filtered keypoints (tracker.py:276-292) for ALL
        tracks in ONE fixed-shape solve on the device (cfg.max_tracks padded
        slots — invalid slots carry the -10000 sentinel so n_valid=0 ⇒
        valid=False), fetched to the host once.

        `items` is [(track, kps, scale, kps_conf), ...]; returns a parallel
        list of pnp_shell tuples or None.
        """
        # Imported here: the detector module imports this one.
        from centerpose_tpu_torch.inference.detector import pnp_shell_epilogue

        if self.meta is None or "camera_matrix" not in self.meta or not items:
            return [None] * len(items)

        m = self.cfg.max_tracks
        kps_pad = np.full((m, 8, 2), -10000.0, np.float32)
        # Unit cuboid in padded slots keeps the branchless solver well-posed.
        cuboids = np.tile(cuboid_vertices(np.ones(3)), (m, 1, 1))
        for i, (_, kps, scale, _) in enumerate(items):
            kps_pad[i] = np.asarray(kps, np.float64).reshape(8, 2)
            s = np.asarray(scale, np.float64)
            cuboids[i] = cuboid_vertices(s / max(float(s[1]), 1e-9))

        res = solve_pnp_batch(
            kps_pad, cuboids.astype(np.float32),
            np.asarray(self.meta["camera_matrix"], np.float32), device=self.device,
        )
        res = PnPResult(*[v.cpu().numpy() for v in res])

        outs = []
        for i, (track, _, _, _) in enumerate(items):
            if not bool(res.valid[i]):
                outs.append(None)
                continue
            location = res.translation_gl[i].astype(np.float64)
            track["location"] = location.tolist()
            track["quaternion_xyzw"] = res.quaternion_gl[i].tolist()

            proj9, pts3d, kps9, ok = pnp_shell_epilogue(
                cuboids[i], res.rotation_gl[i].astype(np.float64), location,
                np.asarray(res.projected[i], np.float64),
                self.meta["width"], self.meta["height"], self.cfg.category,
                track["kps"],
            )
            if not ok:
                outs.append(None)
                continue
            outs.append((proj9, pts3d, np.asarray(track["obj_scale"]), kps9, track))
        return outs
