"""Objectron-style evaluator: detector → matched metrics → AP report.

Parity target: `Evaluator` (src/tools/objectron_eval/eval_image_official.py:129-1183
and eval_video_official.py:159-1560):
  * greedy pred→GT matching by keypoint L2 (`match_box`, :1076-1096);
  * plane-based metric-scale recovery (`compute_scale`, :795-803): the predicted
    (height-normalized) box is scaled so its bottom face sits on the GT ground plane;
  * 7 metric families over 21-threshold AP curves: 3D IoU (with rotation sweep for
    symmetric categories), 2D pixel error, azimuth/polar viewpoint error, ADD/ADD-S,
    scale error (:59-64,664-994);
  * video consistency score: mean pairwise 3D IoU of predictions in a sliding window
    per GT instance (eval_video_official.py:811-853);
  * text AP report (`write_report`, :1098-1169).

Data sources: DOPE-style png+json pairs (the reference's own offline-preprocessed
format, data/preprocess.py) via `evaluate_dataset`, or Objectron TFRecords via
`evaluate_tfrecords` using the dependency-free reader in
centerpose_tpu_torch/data/tfrecord.py (no TensorFlow needed).

The PyTorch package's copy of `centerpose_tpu/evaluation/evaluator.py`: the
metrics in float64 numpy on the host, the 3D IoU in the package's own C++
library (`native/iou3d.cpp`). The detector the drivers take is the package's
`inference/detector.py::Detector` (on the GPU or the CPU), or anything with
its `run(image, meta)`, `run_pnp(dets, meta)` and `reset_tracking()`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centerpose_tpu_torch.config import SYMMETRIC_CATEGORIES, CenterPoseConfig
from centerpose_tpu_torch.evaluation.iou3d import OrientedBox, box_iou_3d, iou_with_symmetry_sweep
from centerpose_tpu_torch.evaluation.metrics import (
    THRESH_2D_PIXEL,
    THRESH_3D_IOU,
    THRESH_ADD,
    THRESH_AZIMUTH,
    THRESH_POLAR,
    THRESH_SCALE,
    AveragePrecision,
    HitMiss,
    add_metric,
    adds_metric,
    azimuth_polar_error,
    pixel_error_2d,
    scale_error,
)

_FAMILIES = ("iou3d", "pixel2d", "azimuth", "polar", "add", "adds", "scale")
_THRESH = {
    "iou3d": THRESH_3D_IOU,
    "pixel2d": THRESH_2D_PIXEL,
    "azimuth": THRESH_AZIMUTH,
    "polar": THRESH_POLAR,
    "add": THRESH_ADD,
    "adds": THRESH_ADD,
    "scale": THRESH_SCALE,
}
_GREATER = {"iou3d": True}  # all others are error metrics (hit = metric <= thresh)
_REPORT_POINT = {
    "iou3d": 0.5, "pixel2d": 0.1, "azimuth": 30.0, "polar": 20.0,
    "add": 0.1, "adds": 0.1, "scale": 0.5,
}


@dataclasses.dataclass
class GroundTruthInstance:
    kps_2d_norm: np.ndarray   # [9, 2] normalized image coords (center first)
    kps_3d_cam: np.ndarray    # [9, 3] OpenGL camera frame
    scale: np.ndarray         # [3]
    rotation: np.ndarray      # [3, 3] object→camera
    translation: np.ndarray   # [3]
    visibility: float = 1.0
    # Cup category only: per-instance mug flag from the hand relabel lists
    # (parser.py:157-185). With eval_mug_symmetric=False, matched mugs skip
    # the rotation-symmetry sweep (eval_image_official.py:712-715, 784-787).
    mug: Optional[bool] = None


def parse_gt_json(path: str) -> Tuple[List[GroundTruthInstance], Optional[tuple], dict]:
    """Parse a DOPE-style annotation json into GT instances + ground plane."""
    from scipy.spatial.transform import Rotation as R

    with open(path) as f:
        anns = json.load(f)
    cam = anns.get("camera_data", {})
    width = cam.get("width", 640)
    height = cam.get("height", 480)

    instances = []
    for obj in anns.get("objects", []):
        kps2d = np.asarray(obj["projected_cuboid"], np.float64)[:9].copy()
        kps2d[:, 0] /= width
        kps2d[:, 1] /= height
        instances.append(
            GroundTruthInstance(
                kps_2d_norm=kps2d,
                kps_3d_cam=np.asarray(obj["keypoints_3d"], np.float64)[:9],
                scale=np.abs(np.asarray(obj["scale"], np.float64)),
                rotation=R.from_quat(obj["quaternion_xyzw"]).as_matrix(),
                translation=np.asarray(obj["location"], np.float64),
            )
        )
    plane = None
    if "AR_data" in anns:
        plane = (
            np.asarray(anns["AR_data"]["plane_center"], np.float64),
            np.asarray(anns["AR_data"]["plane_normal"], np.float64),
        )
    meta = {"width": width, "height": height, "camera_data": cam}
    return instances, plane, meta


def compute_plane_scale(box9_3d: np.ndarray, plane: tuple) -> float:
    """Metric scale so the box's 4 lowest vertices sit on the plane
    (eval_image_official.py:795-803)."""
    center, normal = plane
    dots = np.sort([float(np.dot(v, normal)) for v in box9_3d[1:]])
    center_dot = float(np.dot(center, normal))
    denom = np.asarray(dots[:4])
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    return float(np.mean(center_dot / denom))


class Evaluator:
    """Accumulates hit/miss records over a detector's predictions."""

    def __init__(
        self,
        config: CenterPoseConfig,
        eval_num_symmetry: Optional[int] = None,
        eval_mug_symmetric: bool = True,
    ):
        self.cfg = config
        if eval_num_symmetry is None:
            eval_num_symmetry = (
                100 if config.category in SYMMETRIC_CATEGORIES else 1
            )  # shell_eval defaults for symmetric categories
        self.eval_num_symmetry = eval_num_symmetry
        # Objectron's paper treats mugs as symmetric for fair comparison
        # (eval_image_official.py:1259-1260 defaults True); False restricts
        # the rotation sweep to 1 for mug instances.
        self.eval_mug_symmetric = eval_mug_symmetric
        self.hm: Dict[str, HitMiss] = {
            f: HitMiss(_THRESH[f]) for f in _FAMILIES
        }
        self.num_gt = 0
        self.num_pred = 0
        self.vis_thresh = 0.5
        # consistency bookkeeping: instance key -> list of (frame_id, OrientedBox)
        self._consistency: Dict[str, List[Tuple[int, OrientedBox]]] = {}

    # ------------------------------------------------------------------ per image
    def evaluate_image(
        self,
        boxes: Sequence[tuple],
        instances: Sequence[GroundTruthInstance],
        plane: Optional[tuple] = None,
        frame_id: Optional[int] = None,
        re_pnp=None,
        video_key: str = "",
    ):
        """Record metrics for one image's PnP-validated detections.

        boxes: detector output tuples (proj9_norm, pts3d_cam, scale_pred, kps9_norm,
        det) — the pnp_shell return quintuple.
        re_pnp: optional `(det, gt_scale) -> (proj9, pts3d) | None` callback
        applied AFTER matching — the reference's `predict_gt_scale`
        (--eval_gt_scale, eval_image_official.py:228-241,399-403) re-runs the
        PnP shell with the matched GT's scale.
        """
        self.num_gt += len(instances)
        if not instances:
            return
        gt_kps = np.stack([g.kps_2d_norm for g in instances])
        vis = np.array([g.visibility for g in instances])

        for box in boxes:
            proj9, pts3d, scale_pred, kps9, det = box
            conf = float(det.get("score", 1.0))
            self.num_pred += 1

            # Greedy match by keypoint L2 (match_box). Like the reference's
            # greedy matcher this is NOT one-to-one: two predictions may claim
            # the same GT (kept for parity — do not "fix").
            norms = np.linalg.norm(gt_kps[:, 1:, :] - np.asarray(kps9)[1:, :], axis=(1, 2))
            i_min = int(np.argmin(norms))
            if vis[i_min] < self.vis_thresh:
                continue
            gt = instances[i_min]

            if re_pnp is not None:
                redone = re_pnp(det, gt.scale)
                if redone is not None:
                    proj9, pts3d = redone

            # Metric-scale recovery from the ground plane.
            pts3d_scaled = np.asarray(pts3d, np.float64)
            if plane is not None:
                s = compute_plane_scale(pts3d_scaled, plane)
                pts3d_scaled = pts3d_scaled * s

            # Matched mugs skip the rotation sweep when mugs are treated as
            # non-symmetric (eval_image_official.py:712-715, 784-787).
            n_sym = (
                1
                if (not self.eval_mug_symmetric and gt.mug)
                else self.eval_num_symmetry
            )

            # Oriented boxes for IoU.
            box_pred = OrientedBox.from_corners_fit(pts3d_scaled[1:])
            box_gt = OrientedBox(
                rotation=gt.rotation, translation=gt.translation, scale=gt.scale
            )
            iou = iou_with_symmetry_sweep(box_pred, box_gt, n_sym)
            self.hm["iou3d"].record_hit_miss(iou, conf, greater=True)

            mo2c = np.eye(4)
            mo2c[:3, :3] = gt.rotation
            mo2c[:3, 3] = gt.translation
            pix = pixel_error_2d(
                proj9, gt.kps_2d_norm,
                num_symmetry=n_sym,
                kps_gt_3d=gt.kps_3d_cam,
                Mo2c=mo2c,
            )
            self.hm["pixel2d"].record_hit_miss(pix, conf, greater=False)

            az, po = azimuth_polar_error(
                box_pred.rotation, gt.rotation,
                num_symmetry=n_sym,
                t_pred=box_pred.translation, t_gt=gt.translation,
            )
            self.hm["azimuth"].record_hit_miss(az, conf, greater=False)
            self.hm["polar"].record_hit_miss(po, conf, greater=False)

            self.hm["add"].record_hit_miss(
                add_metric(pts3d_scaled, gt.kps_3d_cam), conf, greater=False
            )
            self.hm["adds"].record_hit_miss(
                adds_metric(pts3d_scaled, gt.kps_3d_cam), conf, greater=False
            )
            self.hm["scale"].record_hit_miss(
                scale_error(scale_pred, gt.scale), conf, greater=False
            )

            if frame_id is not None:
                # Key includes the video so windows never straddle two videos
                # whose per-video frame ids overlap (consistency is per
                # instance-within-a-video, eval_video_official.py:811-853).
                self._consistency.setdefault(
                    f"{video_key}:{i_min}", []
                ).append((frame_id, box_pred))

    # ------------------------------------------------------------------ results
    def consistency_score(self, window: int = 10) -> float:
        """Mean pairwise 3D IoU within a sliding frame window per instance
        (eval_video_official.py:811-853)."""
        scores = []
        for _, entries in self._consistency.items():
            entries = sorted(entries, key=lambda e: e[0])
            for i in range(len(entries)):
                for j in range(i + 1, len(entries)):
                    if entries[j][0] - entries[i][0] > window:
                        break
                    scores.append(box_iou_3d(entries[i][1], entries[j][1]))
        return float(np.mean(scores)) if scores else 0.0

    # ------------------------------------------------------------ persistence
    def save_stats(self, path: str):
        """Dump raw (hit, conf) records + num_gt for offline re-aggregation —
        the per-video `stats_save` files consumed by group_report_new.py."""
        payload = {
            "num_gt": self.num_gt,
            "num_pred": self.num_pred,
            "records": {f: self.hm[f].records for f in _FAMILIES},
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    def load_and_merge(self, path: str):
        """Merge another shard's raw stats (group_report_new.py re-accumulation:
        global AP is recomputed from the union of confidence-ranked records)."""
        with open(path) as f:
            payload = json.load(f)
        self.num_gt += payload["num_gt"]
        self.num_pred += payload["num_pred"]
        for fam in _FAMILIES:
            for i, recs in enumerate(payload["records"][fam]):
                self.hm[fam].records[i].extend(tuple(r) for r in recs)

    def compute_aps(self) -> Dict[str, np.ndarray]:
        ap = AveragePrecision(num_gt=self.num_gt)
        return {f: ap.compute(self.hm[f]).copy() for f in _FAMILIES}

    def report_dict(self) -> dict:
        """Machine-readable AP report: per family the report-point AP, the full
        21-threshold curve, and the thresholds; plus counts and (for video
        runs) the consistency score. Used by --report_json / ACCURACY artifacts."""
        aps = self.compute_aps()
        out = {
            "category": self.cfg.category,
            "num_gt": self.num_gt,
            "num_pred": self.num_pred,
            "families": {},
        }
        for f in _FAMILIES:
            thr = _THRESH[f]
            i = int(np.argmin(np.abs(thr - _REPORT_POINT[f])))
            out["families"][f] = {
                "report_point": _REPORT_POINT[f],
                "ap": float(aps[f][i]),
                "thresholds": [float(t) for t in thr],
                "curve": [float(v) for v in aps[f]],
            }
        if self._consistency:
            out["consistency"] = self.consistency_score()
        return out

    def report(self) -> str:
        """Text AP table (write_report parity: one AP curve per family)."""
        aps = self.compute_aps()
        lines = [
            f"Evaluation report — category={self.cfg.category} "
            f"num_gt={self.num_gt} num_pred={self.num_pred}",
        ]
        for f in _FAMILIES:
            thr = _THRESH[f]
            point = _REPORT_POINT[f]
            i = int(np.argmin(np.abs(thr - point)))
            lines.append(
                f"  {f:8s} AP@{point:g} = {aps[f][i]:.4f}   curve: "
                + " ".join(f"{v:.3f}" for v in aps[f])
            )
        if self._consistency:
            lines.append(f"  consistency = {self.consistency_score():.4f}")
        return "\n".join(lines)


@dataclasses.dataclass
class EvalAblation:
    """Video-eval ablation modes (eval_video_official.py predict :317-480 and the
    shell driver's MODE_0..MODE_8 presets).

    gt_pre_hm_first: seed the tracker with GT detections on each video's first
                     frame (--eval_gt_pre_hm_hmhp_first).
    add_noise:       gaussian-perturb the seeded GT keypoints (--eval_add_noise),
                     std = noise_std × box size.
    fake_output:     propagate the previous frame's boxes as this frame's output —
                     the pure-pipeline null test (--eval_fake_output, :458-478).
    """

    gt_pre_hm_first: bool = False
    add_noise: bool = False
    noise_std: float = 0.05
    fake_output: bool = False
    # MODE_5: seed the tracker's first frame with a CenterPose IMAGE model's
    # detections instead of GT (--eval_CenterPose_initialization,
    # eval_video_official.py:392-480). Requires `init_detector`.
    centerpose_init: bool = False


def _detector_pre_dets(boxes, width, height):
    """Tracker-seed detections from a CenterPose image model's PnP-validated
    boxes (eval_video_official.py:338-380, MODE_5): the seed keypoints are the
    PnP-projected cuboid (box_point_2d, normalized 9x2) scaled to pixels —
    not the raw detection kps — with the same near-zero-uncertainty full
    field template as the GT seeds."""
    dets = []
    for proj9, _, scale_pred, _, det in boxes:
        kps9 = np.asarray(proj9, np.float64)[:, :2].copy()
        kps9[:, 0] *= width
        kps9[:, 1] *= height
        bbox = np.array(
            [kps9[:, 0].min(), kps9[:, 1].min(), kps9[:, 0].max(), kps9[:, 1].max()]
        )
        kps16 = kps9[1:].reshape(-1)
        dets.append(
            {
                "score": 1.0,
                "cls": 0,
                "bbox": bbox,
                "ct": [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                "kps": kps16,
                "tracking": np.zeros(2),
                "tracking_hp": np.zeros(16),
                "obj_scale": np.asarray(scale_pred, np.float64),
                "obj_scale_uncertainty": np.ones(3) * 1e-4,
                "kps_displacement_mean": kps16,
                "kps_displacement_std": np.ones(16) * 1e-4,
                "kps_heatmap_mean": kps16,
                "kps_heatmap_std": np.ones(16) * 1e-4,
                "kps_heatmap_height": np.ones(8),
                "kps_fusion_mean": kps16,
                "kps_fusion_std": np.ones(16) * 1e-4,
            }
        )
    return dets


def _gt_pre_dets(instances, width, height, rng, ablation: EvalAblation):
    """Build tracker-seed detections from GT (eval_video predict :317-420)."""
    dets = []
    for gt in instances:
        kps_px = gt.kps_2d_norm[1:].copy()
        kps_px[:, 0] *= width
        kps_px[:, 1] *= height
        if ablation.add_noise:
            span = kps_px.max(axis=0) - kps_px.min(axis=0)
            kps_px = kps_px + rng.randn(*kps_px.shape) * ablation.noise_std * span
        bbox = np.array(
            [kps_px[:, 0].min(), kps_px[:, 1].min(),
             kps_px[:, 0].max(), kps_px[:, 1].max()]
        )
        kps16 = kps_px.reshape(-1)
        dets.append(
            {
                "score": 1.0,
                "cls": 0,
                "bbox": bbox,
                "ct": [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                "kps": kps16,
                "tracking": np.zeros(2),
                "tracking_hp": np.zeros(16),
                "obj_scale": gt.scale / max(gt.scale[1], 1e-9),
                # Full seed field template (eval_video_official.py:361-380):
                # near-zero uncertainties so the seed dominates the KF and
                # scale pool, and fusion stats so init_track builds a KF.
                "obj_scale_uncertainty": np.ones(3) * 1e-4,
                "kps_displacement_mean": kps16,
                "kps_displacement_std": np.ones(16) * 1e-4,
                "kps_heatmap_mean": kps16,
                "kps_heatmap_std": np.ones(16) * 1e-4,
                "kps_heatmap_height": np.ones(8),
                "kps_fusion_mean": kps16,
                "kps_fusion_std": np.ones(16) * 1e-4,
            }
        )
    return dets


def _mobilepose_lift_boxes(boxes, camera, width, height):
    """Replace each box's (proj9, pts3d) with the MobilePose EPnP lifting
    (--eval_MobilePose_postprocessing, eval_image_official.py:391-393)."""
    from centerpose_tpu_torch.evaluation.mobilepose import lift_2d_to_3d

    out = []
    for proj9, pts3d, scale_pred, kps9, det in boxes:
        kps = np.asarray(det["kps"], np.float64).reshape(-1, 2)[:8]
        proj9_l, pts3d_l = lift_2d_to_3d(kps, camera, width, height)
        out.append((proj9_l, pts3d_l, scale_pred, kps9, det))
    return out


def _make_gt_scale_re_pnp(detector, camera, width, height):
    """predict_gt_scale callback: re-run the PnP shell with the matched GT's
    height-normalized scale (eval_image_official.py:228-241)."""
    meta = {"camera_matrix": camera, "width": width, "height": height}

    def re_pnp(det, gt_scale):
        det2 = dict(det)
        det2["obj_scale"] = np.asarray(gt_scale, np.float64) / max(
            float(gt_scale[1]), 1e-9
        )
        boxes = detector.run_pnp([det2], meta)
        if not boxes:
            return None
        return boxes[0][0], boxes[0][1]

    return re_pnp


def evaluate_tfrecords(
    detector,
    record_paths: Sequence[str],
    config: CenterPoseConfig,
    max_images: Optional[int] = None,
    is_video: bool = False,
    ablation: Optional[EvalAblation] = None,
    eval_num_symmetry: Optional[int] = None,
    mobilepose_postprocess: bool = False,
    gt_scale: bool = False,
    init_detector=None,
    detector_mug=None,
    relabel=None,
    mug_only: Optional[bool] = None,
    eval_mug_symmetric: bool = True,
) -> Evaluator:
    """Objectron tfrecord evaluation path (eval_image_official.py:1186-1211 /
    eval_video_official.py Dataloader), using the native TFRecord reader
    (centerpose_tpu_torch/data/tfrecord.py) instead of tf.data.

    init_detector: a CenterPose IMAGE-model detector used to seed the tracker
    on each video's first frame when ablation.centerpose_init is set (MODE_5).

    Cup/mug dual-model path (eval_image_official.py:166-226,297-346): for
    category 'cup', `detector_mug` holds the MUG sub-model and `detector` the
    (12-fold-symmetric) CUP sub-model; each sample's GT is relabeled by the
    hand lists (`relabel`: a RelabelLists), routed to one of the two
    detectors, and optionally filtered by `mug_only` (True = only mug
    samples, False = only cup samples, None = all)."""
    import io

    from PIL import Image

    from centerpose_tpu_torch.data.tfrecord import parse_objectron_example, read_tfrecord
    from centerpose_tpu_torch.evaluation.relabel import (
        RelabelLists,
        mug_only_skip,
        route_mug_detector,
    )

    evaluator = Evaluator(config, eval_num_symmetry, eval_mug_symmetric)
    ablation = ablation or EvalAblation()
    is_cup = config.category == "cup"
    if is_cup and relabel is None:
        relabel = RelabelLists.resolve()  # $CENTERPOSE_LABEL_DIR, may be None
    if is_cup and relabel is None:
        # Empty lists: every instance routes as a mug (parser.py:159-165
        # default). Loud, because with a mug detector configured this means
        # the cup sub-model never runs.
        print(
            "WARNING: cup evaluation without relabel lists "
            "(--label_dir / $CENTERPOSE_LABEL_DIR unset) — every instance "
            "is treated as a mug", flush=True,
        )
        relabel = RelabelLists()
    rng = np.random.RandomState(0)
    count = 0
    prev_boxes = []
    for ridx, path in enumerate(record_paths):
        if is_video:
            detector.reset_tracking()
            if detector_mug is not None:
                detector_mug.reset_tracking()
            prev_boxes = []
        for fidx, payload in enumerate(read_tfrecord(path)):
            if max_images and count >= max_images:
                return evaluator
            ex = parse_objectron_example(payload)
            if "image_bytes" not in ex or ex.get("num_instances", 0) == 0:
                continue
            img = np.asarray(Image.open(io.BytesIO(ex["image_bytes"])).convert("RGB"))
            h, w = img.shape[:2]

            n_inst = ex["num_instances"]
            pts2d = [np.asarray(ex["points_2d"][i], np.float64)[:9] for i in range(n_inst)]
            pts3d = [np.asarray(ex["points_3d"][i], np.float64)[:9] for i in range(n_inst)]
            rots = np.asarray(ex["rotations"], np.float64).copy()

            mug_flags = None
            active = detector
            if is_cup:
                video_name = str(ex.get("filename", "")).replace("/", "_")
                p2 = np.stack(pts2d)
                p3 = np.stack(pts3d)
                mug_flags = relabel.apply_mug_relabel(video_name, p2, p3, rots)
                pts2d = [p2[i] for i in range(n_inst)]
                pts3d = [p3[i] for i in range(n_inst)]
                if mug_only_skip(mug_flags, mug_only):
                    continue
                if route_mug_detector(mug_flags) and detector_mug is not None:
                    active = detector_mug

            instances = []
            vis = ex.get("visibilities", np.ones(n_inst))
            for i in range(n_inst):
                instances.append(
                    GroundTruthInstance(
                        kps_2d_norm=pts2d[i],
                        kps_3d_cam=pts3d[i],
                        scale=np.abs(np.asarray(ex["scales"][i], np.float64)),
                        rotation=rots[i],
                        translation=np.asarray(ex["translations"][i], np.float64),
                        visibility=float(vis[i]) if i < len(vis) else 1.0,
                        mug=bool(mug_flags[i]) if mug_flags is not None else None,
                    )
                )
            input_meta = {}
            if "intrinsics" in ex:
                # Objectron intrinsics are stored transposed relative to image
                # x/y (data/utils.py:115-121 swaps fx/fy, cx/cy).
                k = np.asarray(ex["intrinsics"])
                input_meta["camera_matrix"] = np.array(
                    [[k[1, 1], 0, k[1, 2]], [0, k[0, 0], k[0, 2]], [0, 0, 1]]
                )
            # MODE_5 sets both gt_pre_hm_first and centerpose_init; the
            # CenterPose initialization takes precedence (the point of the
            # mode is replacing the GT seed with a detector's).
            if (
                is_video and fidx == 0 and ablation.centerpose_init
                and init_detector is not None
            ):
                init_out = init_detector.run(img, input_meta or None)
                input_meta["pre_dets"] = _detector_pre_dets(
                    init_out["boxes"], w, h
                )
            elif is_video and fidx == 0 and ablation.gt_pre_hm_first:
                input_meta["pre_dets"] = _gt_pre_dets(
                    instances, w, h, rng, ablation
                )
            if ablation.fake_output and fidx > 0:
                boxes = prev_boxes  # pipeline null test: reuse previous frame
            else:
                out = active.run(img, input_meta or None)
                boxes = out["boxes"]
            prev_boxes = boxes
            cam = input_meta.get("camera_matrix")
            if mobilepose_postprocess and cam is not None:
                boxes = _mobilepose_lift_boxes(boxes, cam, w, h)
            re_pnp = (
                _make_gt_scale_re_pnp(active, cam, w, h)
                if gt_scale and cam is not None
                else None
            )
            evaluator.evaluate_image(
                boxes, instances, ex.get("plane"), fidx if is_video else None,
                re_pnp=re_pnp, video_key=str(ridx),
            )
            count += 1
    return evaluator


def evaluate_dataset(
    detector,
    data_root: str,
    config: CenterPoseConfig,
    max_images: Optional[int] = None,
    is_video: bool = False,
    eval_num_symmetry: Optional[int] = None,
    mobilepose_postprocess: bool = False,
    gt_scale: bool = False,
    video_filter: Optional[Sequence[str]] = None,
) -> Evaluator:
    """Run the detector over a DOPE-style dataset directory and accumulate AP.

    `video_filter`: restrict to these video ids (the reference's
    --eval_hard_case subset evaluation, eval_video_official.py:1574-1603).
    """
    from PIL import Image

    from centerpose_tpu_torch.data.dataset import find_samples

    evaluator = Evaluator(config, eval_num_symmetry)
    samples = find_samples(data_root)
    if video_filter:
        keep = set(video_filter)
        samples = [s for s in samples if s[1] in keep]
    if max_images:
        samples = samples[:max_images]

    last_video = None
    for img_path, video_id, frame_id, json_path in samples:
        if is_video and video_id != last_video:
            detector.reset_tracking()
            last_video = video_id
        instances, plane, meta = parse_gt_json(json_path)
        img = np.asarray(Image.open(img_path).convert("RGB"))
        cam = meta["camera_data"].get("intrinsics")
        input_meta = {}
        if cam:
            input_meta["camera_matrix"] = np.array(
                [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]]
            )
        out = detector.run(img, input_meta or None)
        boxes = out["boxes"]
        cam_m = input_meta.get("camera_matrix")
        h, w = img.shape[:2]
        if mobilepose_postprocess and cam_m is not None:
            boxes = _mobilepose_lift_boxes(boxes, cam_m, w, h)
        re_pnp = (
            _make_gt_scale_re_pnp(detector, cam_m, w, h)
            if gt_scale and cam_m is not None
            else None
        )
        evaluator.evaluate_image(
            boxes, instances, plane, frame_id if is_video else None,
            re_pnp=re_pnp, video_key=str(video_id),
        )
    return evaluator
