"""Objectron training dataset (DOPE-style png+json pairs).

The PyTorch package's own copy of `centerpose_tpu/data/dataset.py`; from the
same files and RNG seed it gives the same samples, key for key, for the image
model and for the tracking model (CenterPoseTrack). Parity target:
`ObjectPoseDataset` (src/lib/datasets/dataset_combined.py:54-1207):
  * recursive image/json discovery with video grouping (:177-228);
  * affine augmentation: random crop centers + scale choice 0.6..1.3, optional
    rotation, horizontal flip with keypoint index swaps (:240-288,330-350);
  * CornerNet-style PCA color augmentation (utils/image.py:239-277);
  * the `--new_data_augmentation` raw-image degradations (:307-318);
  * symmetry handling: for symmetric categories, N GT copies are generated by
    rotating the object's 3D keypoints about its local y axis and re-projecting
    through the annotation's projection matrix (:979-1012); every GT tensor carries
    a leading num_symmetry axis;
  * GT target rendering (:1062-1157) — delegated to data/targets.py;
  * corrupt samples return None, filtered by the collate (dataset_factory.py:8-14);
  * with `config.tracking_task`, the previous-frame branch
    (:438-452, 711-744, 877-937): a neighbouring frame of the same video
    within `max_frame_dist`, warped with disturbed centre and scale, its
    noisy `pre_hm` / `pre_hm_hp` (truncated-normal centre jitter, lost and
    false-positive draws, per keypoint too) or, with probability
    `data_generation_mode_ratio` when a `detector` is given, heatmaps of
    that detector's PnP-surviving boxes (:465-501, 668-693); the
    `tracking` / `tracking_hp` targets pair the kept annotations with the
    previous frame's objects by `name`. The draws come in the JAX
    package's order, so one seed gives the same samples.

Compact wire (`compact_wire=True`, `train.py --wire compact`): images ship as
uint8 (`pre_img` too: the exact inverse of its mean/std normalisation) and
heatmaps (`hm`, `hm_hp`, `pre_hm`, `pre_hm_hp`) as uint8 in 1/255 steps,
decoded on the device by `training/trainer.py::decode_wire` (v / 255). Deliberate divergence from the
JAX package, which rounds every heatmap value to the nearest step: a gaussian
shoulder at or above 254.5/255 (~0.998) rounds there to 255, decodes to 1.0
and becomes a spurious positive of the focal loss (`gt == 1`). Here a value
below 1 encodes as at most 254 and only a peak of exactly 1 as 255
(`encode_heatmap`); every other value is the JAX package's.

JSON schema (written by the reference's own preprocessor, data/utils.py:95-290):
camera_data{width,height,camera_projection_matrix,intrinsics{fx,fy,cx,cy}},
objects[{name, location, quaternion_xyzw, projected_cuboid (9x2, center first),
scale (3,), keypoints_3d (9x3)}].
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centerpose_tpu_torch.config import FLIP_IDX, CenterPoseConfig, DATA_MEAN, DATA_STD
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets
from centerpose_tpu_torch.geometry.affine import (
    affine_transform_points,
    get_affine_transform,
    warp_affine_u8,
)
from centerpose_tpu_torch.geometry.gaussian import draw_gaussian, gaussian_radius

# CornerNet PCA color-augmentation basis (utils/image.py eig constants convention).
_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
_EIG_VEC = np.array(
    [
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938],
    ],
    np.float32,
)


def rotation_y_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def find_samples(root: str) -> List[Tuple[str, str, int, str]]:
    """Recursively find (img_path, video_id, frame_id, json_path) tuples.

    Video id = containing directory; frame id = numeric stem when parseable
    (dataset_combined.py:177-228 discovery + :218-228 grouping).
    """
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            stem = os.path.splitext(fn)[0]
            jpath = os.path.join(dirpath, stem + ".json")
            if not os.path.exists(jpath):
                continue
            try:
                frame_id = int(stem)
            except ValueError:
                frame_id = 0
            out.append((os.path.join(dirpath, fn), os.path.basename(dirpath), frame_id, jpath))
    return out


def color_augment(rng: np.random.RandomState, img01: np.ndarray) -> np.ndarray:
    """Brightness/contrast/saturation jitter + PCA lighting, in [0,1] RGB
    (utils/image.py:239-277 semantics)."""
    gs = img01 @ np.array([0.299, 0.587, 0.114], np.float32)
    gs_mean = gs.mean()

    # Apply the three blends in random order like the reference.
    def blend_sat(x, alpha):
        return x * alpha + gs[..., None] * (1 - alpha)

    def blend_con(x, alpha):
        return x * alpha + gs_mean * (1 - alpha)

    fns = [
        lambda x: x * (1.0 + rng.uniform(-0.4, 0.4)),       # brightness
        lambda x: blend_con(x, 1.0 + rng.uniform(-0.4, 0.4)),  # contrast
        lambda x: blend_sat(x, 1.0 + rng.uniform(-0.4, 0.4)),  # saturation
    ]
    order = rng.permutation(3)
    for i in order:
        img01 = fns[i](img01)
    alpha = rng.normal(scale=0.1, size=(3,)).astype(np.float32)
    img01 = img01 + _EIG_VEC @ (_EIG_VAL * alpha)
    return img01


def _motion_blur(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """albumentations MotionBlur(blur_limit=3): a random 1px line through a
    3x3 kernel, normalized, correlated over the image (reflect-101 border)."""
    k = np.zeros((3, 3), np.float32)
    xs, xe = rng.randint(0, 3), rng.randint(0, 3)
    if xs == xe:
        ys, ye = rng.choice(3, size=2, replace=False)
    else:
        ys, ye = rng.randint(0, 3), rng.randint(0, 3)
    # Bresenham raster (what cv2.line thickness-1 draws).
    x0, y0, x1, y1 = int(xs), int(ys), int(xe), int(ye)
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx - dy
    while True:
        k[y0, x0] = 1.0
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy
    k /= k.sum()
    from scipy import ndimage

    # cv2.filter2D is CORRELATION with BORDER_REFLECT_101 == scipy 'mirror'.
    return ndimage.correlate(img, k[:, :, None], mode="mirror")


def _nearest_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    h, w = img.shape[:2]
    ri = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
    ci = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
    return img[ri][:, ci]


def _downscale(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """albumentations Downscale(0.6..0.8): nearest-neighbor down + back up."""
    h, w = img.shape[:2]
    scale = rng.uniform(0.6, 0.8)
    dh, dw = max(1, int(h * scale)), max(1, int(w * scale))
    return _nearest_resize(_nearest_resize(img, dh, dw), h, w)


def _gauss_noise(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """albumentations GaussNoise(var_limit=(10, 50)): clipped additive noise."""
    sigma = rng.uniform(10.0, 50.0) ** 0.5
    noise = rng.normal(0.0, sigma, img.shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 255.0)


def new_data_augment(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """The reference's `--new_data_augmentation` branch, dependency-free.

    Parity target: dataset_combined.py:307-318 — an albumentations Compose of
    MotionBlur(blur_limit=3, p=0.1), Downscale(scale 0.6..0.8, p=0.1),
    GaussNoise(p=0.2) applied to the raw 0..255 image BEFORE the affine warp
    (spatial-only; GT labels untouched). Re-expressed in numpy/scipy: the
    nearest-resize pixel phase is the standard floor map (cv2's half-down
    quirk is not semantically meaningful for a stochastic degradation).
    """
    was_u8 = img.dtype == np.uint8
    img = np.asarray(img, np.float32)
    if rng.random_sample() < 0.1:
        img = _motion_blur(rng, img)
    if rng.random_sample() < 0.1:
        img = _downscale(rng, img)
    if rng.random_sample() < 0.2:
        img = _gauss_noise(rng, img)
    if was_u8:
        # albumentations keeps uint8 images uint8; quantizing here also keeps
        # the PIL fast-path warp (warp_affine_u8) engaged downstream.
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img


def encode_heatmap(v: np.ndarray) -> np.ndarray:
    """[0, 1] heatmap -> uint8 steps of 1/255 for the compact wire: to the
    nearest step, except that a value below 1 stays at most 254, so that only
    a peak (exactly 1) decodes to 1 (see the module docstring)."""
    q = np.clip(np.round(v * 255.0), 0, 255)
    return np.where(v < 1.0, np.minimum(q, 254), q).astype(np.uint8)


class ObjectPoseDataset:
    """Map-style dataset; __getitem__ returns a dict of numpy arrays or None.

    With config.tracking_task the sample also carries pre_img / pre_hm /
    pre_hm_hp from a neighbouring frame of the same video and the tracking /
    tracking_hp offset targets (prev − cur), as the module docstring says.
    """

    def __init__(
        self,
        root: str,
        config: CenterPoseConfig,
        split: str = "train",
        rand_crop: bool = True,
        flip_prob: float = 0.5,
        aug_rot_prob: float = 0.0,
        rotate_deg: float = 0.0,
        color_aug: bool = True,
        new_data_aug: bool = False,
        seed: int = 123,
        # tracking noise simulation (main_CenterPoseTrack.py:162-182 defaults)
        max_frame_dist: int = 3,
        hm_disturb: float = 0.05,
        lost_disturb: float = 0.2,
        fp_disturb: float = 0.1,
        hp_lost_disturb: float = 0.1,
        hp_fp_disturb: float = 0.05,
        pre_shift: float = 0.05,
        pre_scale: float = 0.05,
        detector=None,
        data_generation_mode_ratio: float = 0.0,
        compact_wire: bool = False,
    ):
        self.cfg = config
        # Compact wire encoding (train.py --wire compact): images ship as
        # uint8 and [0,1] heatmap targets as uint8/255; the train/eval steps
        # normalize ON DEVICE (training/trainer.py decode_wire).
        self.compact_wire = compact_wire
        self.split = split
        self.rand_crop = rand_crop
        self.flip_prob = flip_prob if split == "train" else 0.0
        self.aug_rot_prob = aug_rot_prob
        self.rotate_deg = rotate_deg
        self.color_aug = color_aug and split == "train"
        # --new_data_augmentation (dataset_combined.py:307-318): raw-image
        # degradations, train split only.
        self.new_data_aug = new_data_aug and split == "train"
        self.samples = find_samples(root)
        self.rng = np.random.RandomState(seed)
        self.videos: Dict[str, List[int]] = {}
        for i, (_, vid, _, _) in enumerate(self.samples):
            self.videos.setdefault(vid, []).append(i)
        self.max_frame_dist = max_frame_dist
        self.hm_disturb = hm_disturb
        self.lost_disturb = lost_disturb
        self.fp_disturb = fp_disturb
        self.hp_lost_disturb = hp_lost_disturb
        self.hp_fp_disturb = hp_fp_disturb
        self.pre_shift = pre_shift
        self.pre_scale = pre_scale
        # Detector-in-the-loop Track data generation (dataset_combined.py:465-501):
        # with probability data_generation_mode_ratio the previous-frame heatmaps
        # come from a trained CenterPose detector's PnP-reprojected predictions
        # (`inference/detector.py::Detector`, or anything whose `run(image,
        # meta)` returns its `boxes`) instead of noise-disturbed GT.
        self.detector = detector
        self.data_generation_mode_ratio = data_generation_mode_ratio

    def __len__(self) -> int:
        return len(self.samples)

    # ------------------------------------------------------------------ aug
    @staticmethod
    def _border(border: int, size: int) -> int:
        i = 1
        while size - border // i <= border // i:
            i *= 2
        return border // i

    def _aug_params(self, c, s, width, height):
        rng = self.rng
        if self.rand_crop:
            aug_s = rng.choice(np.arange(0.6, 1.4, 0.1))
            wb = self._border(128, width)
            hb = self._border(128, height)
            c = np.array(
                [rng.randint(wb, width - wb), rng.randint(hb, height - hb)],
                np.float32,
            )
        else:
            sf, cf = 0.4, 0.1
            c = c.copy()
            c[0] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
            c[1] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
            aug_s = np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        rot = 0.0
        if rng.random_sample() < self.aug_rot_prob:
            rot = 2 * (rng.random_sample() - 0.5) * self.rotate_deg
        return c, float(aug_s), float(rot)

    # ------------------------------------------------------------------ item
    def __getitem__(self, index: int) -> Optional[Dict[str, np.ndarray]]:
        cfg = self.cfg
        img_path, video_id, frame_id, json_path = self.samples[index]
        try:
            from PIL import Image

            img = np.asarray(Image.open(img_path).convert("RGB"))
            with open(json_path) as f:
                anns = json.load(f)
        except Exception:
            return None  # corrupt sample → filtered by collate

        if self.new_data_aug:
            img = new_data_augment(self.rng, img)

        height, width = img.shape[:2]
        c_ori = np.array([width / 2.0, height / 2.0], np.float32)
        s_ori = float(max(height, width))

        flipped = False
        if self.split == "train":
            c, aug_s, rot = self._aug_params(c_ori, s_ori, width, height)
            s = s_ori * aug_s
            if self.rng.random_sample() < self.flip_prob:
                flipped = True
                img = img[:, ::-1, :]
                c[0] = width - c[0] - 1
        else:
            c, s, rot = c_ori, s_ori, 0.0

        trans_input = get_affine_transform(c, s, rot, (cfg.input_w, cfg.input_h))
        inp = warp_affine_u8(img, trans_input, (cfg.input_w, cfg.input_h)) / 255.0
        if self.color_aug:
            inp = color_augment(self.rng, inp.astype(np.float32))
        if self.compact_wire:
            inp = np.clip(np.round(inp * 255.0), 0, 255).astype(np.uint8)
        else:
            inp = (inp - np.array(DATA_MEAN, np.float32)) / np.array(DATA_STD, np.float32)

        trans_output = get_affine_transform(c, s, rot, (cfg.output_w, cfg.output_h))

        proj_matrix = None
        if "camera_data" in anns and "camera_projection_matrix" in anns["camera_data"]:
            proj_matrix = np.array(anns["camera_data"]["camera_projection_matrix"])

        objects: List[ObjectAnnotation] = []
        kept_anns: List[dict] = []  # stays PAIRED with `objects` (skips filtered)
        for ann in anns.get("objects", [])[: cfg.max_objs]:
            # Cup sub-model selection (dataset_combined.py:568-569, 970-971):
            # the cup category trains two models — skip annotations whose
            # offline-preprocessed 'mug' relabel disagrees with cfg.mug.
            if cfg.category == "cup" and bool(ann.get("mug", False)) != cfg.mug:
                continue
            obj = self._build_annotation(
                ann, width, height, flipped, trans_output, proj_matrix, rot
            )
            if obj is not None:
                objects.append(obj)
                kept_anns.append(ann)

        if cfg.tracking_task:
            prev = self._prev_frame_sample(index, c_ori, s_ori, rot, flipped)
            if prev is None:
                return None
            pre_img, pre_hm, pre_hm_hp, prev_tracks = prev
            self._attach_tracking_targets(objects, kept_anns, prev_tracks)
            targets = render_targets(objects, cfg)
            targets["pre_img"] = pre_img.astype(np.float32)
            targets["pre_hm"] = pre_hm.astype(np.float32)
            targets["pre_hm_hp"] = pre_hm_hp.astype(np.float32)
        else:
            targets = render_targets(objects, cfg)
        if self.compact_wire:
            for k in ("hm", "hm_hp", "pre_hm", "pre_hm_hp"):
                if k in targets:
                    targets[k] = encode_heatmap(targets[k])
            if "pre_img" in targets:
                # pre_img arrives normalized from the tracking branch; wire
                # it back to raw uint8 (exact inverse of the mean/std).
                raw = (
                    targets["pre_img"] * np.array(DATA_STD, np.float32)
                    + np.array(DATA_MEAN, np.float32)
                ) * 255.0
                targets["pre_img"] = np.clip(np.round(raw), 0, 255).astype(np.uint8)
        targets["input"] = (
            inp if self.compact_wire else inp.astype(np.float32)
        )
        targets["meta"] = np.array([c[0], c[1], s, rot], np.float32)
        return targets

    # -------------------------------------------------------- tracking branch
    def _truncnorm2(self):
        """Two truncated-normal(±3σ) draws (dataset_combined.py:711-716)."""
        out = []
        while len(out) < 2:
            v = self.rng.randn()
            if -3.0 <= v <= 3.0:
                out.append(v)
        return out

    def _prev_frame_sample(self, index, c_ori, s_ori, rot, flipped):
        """Load a neighboring frame, warp with disturbed aug params, and render
        noisy pre_hm / pre_hm_hp from its GT. Returns
        (pre_img, pre_hm [H,W,1], pre_hm_hp [H,W,8], {name: (ct_out, kps_out, mask)})."""
        cfg = self.cfg
        img_path, video_id, frame_id, _ = self.samples[index]
        peers = [
            i for i in self.videos.get(video_id, [index])
            if abs(self.samples[i][2] - frame_id) <= self.max_frame_dist
        ]
        prev_idx = int(self.rng.choice(peers)) if peers else index

        p_img_path, _, _, p_json_path = self.samples[prev_idx]
        try:
            from PIL import Image

            p_img = np.asarray(Image.open(p_img_path).convert("RGB"))
            with open(p_json_path) as f:
                p_anns = json.load(f)
        except Exception:
            return None
        height, width = p_img.shape[:2]

        # Disturbed aug params around the ORIGINAL image center/scale with the
        # CURRENT rotation (dataset_combined.py:445-450: _get_aug_param(c_ori,
        # s_ori, disturb=True), s_pre = s_ori·aug_s_pre, trans uses rot) — the
        # prev frame is a near-full-image view even when the current frame is
        # a tight random crop.
        cf, sf = self.pre_shift, self.pre_scale
        c_pre = np.asarray(c_ori, np.float32).copy()
        if self.split == "train":
            c_pre[0] += s_ori * np.clip(self.rng.randn() * cf, -2 * cf, 2 * cf)
            c_pre[1] += s_ori * np.clip(self.rng.randn() * cf, -2 * cf, 2 * cf)
            s_pre = s_ori * np.clip(self.rng.randn() * sf + 1, 1 - sf, 1 + sf)
        else:
            s_pre = s_ori
        if flipped:
            p_img = p_img[:, ::-1, :]

        inp_w, inp_h = cfg.input_w, cfg.input_h
        trans_input_pre = get_affine_transform(c_pre, s_pre, rot, (inp_w, inp_h))
        pre_img = warp_affine_u8(p_img, trans_input_pre, (inp_w, inp_h)) / 255.0
        pre_img = (
            pre_img - np.array(DATA_MEAN, np.float32)
        ) / np.array(DATA_STD, np.float32)

        pre_hm = np.zeros((inp_h, inp_w, 1), np.float32)
        pre_hm_hp = np.zeros((inp_h, inp_w, cfg.num_joints), np.float32)
        prev_tracks = {}

        # Detector-in-the-loop branch (data_generation_mode == 1).
        if (
            self.detector is not None
            and self.rng.random_sample() < self.data_generation_mode_ratio
        ):
            return self._detector_prev_sample(
                p_img, p_anns, pre_img, pre_hm, pre_hm_hp, trans_input_pre,
                width, height, flipped,
            )

        for ann in p_anns.get("objects", [])[: cfg.max_objs]:
            try:
                pts9 = np.asarray(ann["projected_cuboid"], np.float64)[:9].copy()
            except (KeyError, TypeError, ValueError):
                continue  # malformed prev annotation — skip, don't crash a worker
            vis = (
                (pts9[1:, 0] < width) & (pts9[1:, 0] >= 0)
                & (pts9[1:, 1] >= 0) & (pts9[1:, 1] < height)
            )
            if flipped:
                pts9[:, 0] = width - pts9[:, 0] - 1
                kp = pts9[1:]
                for a, bsw in FLIP_IDX:
                    ia, ib = a - 1, bsw - 1
                    kp[[ia, ib]] = kp[[ib, ia]]
                    vis[[ia, ib]] = vis[[ib, ia]]
            pts_inp = affine_transform_points(pts9[1:], trans_input_pre)
            bbox = np.array(
                [pts_inp[:, 0].min(), pts_inp[:, 1].min(),
                 pts_inp[:, 0].max(), pts_inp[:, 1].max()]
            )
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, inp_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, inp_h - 1)
            w_box, h_box = bbox[2] - bbox[0], bbox[3] - bbox[1]
            if w_box <= 0 or h_box <= 0:
                continue
            radius = max(0, int(gaussian_radius((math.ceil(h_box), math.ceil(w_box)))))

            ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
            ct0 = ct.copy()
            nx, ny = self._truncnorm2()
            ct = ct + np.array([nx * self.hm_disturb * w_box, ny * self.hm_disturb * h_box])
            ct_int = ct.astype(np.int32)
            if not (0 <= ct_int[0] < inp_w and 0 <= ct_int[1] < inp_h):
                continue

            conf = 0.0 if self.rng.random_sample() < self.lost_disturb else 1.0
            if conf > 0:
                draw_gaussian(pre_hm[:, :, 0], ct_int, radius, k=conf)
                # False positive (dataset_combined.py:929-937).
                if self.rng.random_sample() < self.fp_disturb:
                    ct2 = ct0 + np.array(
                        [self.rng.randn() * 0.05 * w_box, self.rng.randn() * 0.05 * h_box]
                    )
                    draw_gaussian(
                        pre_hm[:, :, 0], ct2.astype(np.int32), radius,
                        k=self.rng.uniform(0, 0.4),
                    )

            # Keypoint heatmaps with their own lost/fp disturbs.
            kps_out = np.full((cfg.num_joints, 2), np.nan)
            for j in range(cfg.num_joints):
                if not vis[j]:
                    continue
                pt = pts_inp[j]
                pt_int = pt.astype(np.int32)
                if not (0 <= pt_int[0] < inp_w and 0 <= pt_int[1] < inp_h):
                    continue
                if conf > 0 and self.rng.random_sample() > self.hp_lost_disturb:
                    draw_gaussian(pre_hm_hp[:, :, j], pt_int, radius, k=1.0)
                    if self.rng.random_sample() < self.hp_fp_disturb:
                        pt2 = pt + np.array(
                            [self.rng.randn() * 0.05 * w_box,
                             self.rng.randn() * 0.05 * h_box]
                        )
                        draw_gaussian(
                            pre_hm_hp[:, :, j], pt2.astype(np.int32), radius,
                            k=self.rng.uniform(0, 0.3),
                        )
                    # prev keypoints in OUTPUT coords (pts_single_pre /
                    # down_ratio, dataset_combined.py:938-940) — recorded ONLY
                    # when the gaussian was actually drawn: tracking_label_mode
                    # 1 (the opts.py default) sets lost keypoints to None/mask
                    # 0 (dataset_combined.py:830-841), so the model is never
                    # trained to regress offsets from deleted heatmap evidence.
                    kps_out[j] = pt / cfg.down_ratio

            name = ann.get("name", "")
            if conf > 0:
                # prev center in OUTPUT coords (the ÷down_ratio convention,
                # dataset_combined.py:742-750: disturbed ct when label_mode 1).
                prev_tracks[name] = (
                    ct / cfg.down_ratio, kps_out, ~np.isnan(kps_out[:, 0])
                )
        return pre_img, pre_hm, pre_hm_hp, prev_tracks

    def _detector_prev_sample(
        self, p_img, p_anns, pre_img, pre_hm, pre_hm_hp, trans_input_pre,
        width, height, flipped=False,
    ):
        """data_generation_mode 1: render pre_hm/pre_hm_hp from a trained
        detector's PnP-reprojected predictions on the previous frame
        (dataset_combined.py:465-501, 668-693)."""
        cfg = self.cfg
        meta = {}
        cam = p_anns.get("camera_data", {}).get("intrinsics")
        if cam:
            meta["camera_matrix"] = np.array(
                [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]]
            )
        out = self.detector.run(np.asarray(p_img, np.uint8), meta or None)

        dets = [b[4] for b in out["boxes"]]  # PnP-surviving detections
        proj9s = [np.asarray(b[0]) for b in out["boxes"]]
        inp_w, inp_h = cfg.input_w, cfg.input_h
        prev_tracks = {}

        for det, proj9 in zip(dets, proj9s):
            bbox = np.asarray(det["bbox"], np.float64).reshape(2, 2)
            bbox = affine_transform_points(bbox, trans_input_pre).reshape(4)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, inp_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, inp_h - 1)
            w_box, h_box = bbox[2] - bbox[0], bbox[3] - bbox[1]
            if w_box <= 0 or h_box <= 0:
                continue
            radius = max(
                0, int(gaussian_radius((math.ceil(h_box), math.ceil(w_box))))
            )
            ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
            ct_int = ct.astype(np.int32)
            if not (0 <= ct_int[0] < inp_w and 0 <= ct_int[1] < inp_h):
                continue
            # render_hm_mode 1: score-scaled center gaussian.
            draw_gaussian(pre_hm[:, :, 0], ct_int, radius, k=float(det["score"]))

            pts = np.asarray(proj9, np.float64)[1:, :2].copy()
            pts[:, 0] *= width
            pts[:, 1] *= height
            pts_inp = affine_transform_points(pts, trans_input_pre)
            conf = np.clip(
                np.asarray(det.get("kps_heatmap_height", np.ones(cfg.num_joints))),
                0.0, 1.0,
            )
            kps_out = np.full((cfg.num_joints, 2), np.nan)
            for j in range(cfg.num_joints):
                pt_int = pts_inp[j].astype(np.int32)
                if 0 <= pt_int[0] < inp_w and 0 <= pt_int[1] < inp_h:
                    if conf[j] > 0:
                        draw_gaussian(
                            pre_hm_hp[:, :, j], pt_int, radius, k=float(conf[j])
                        )
                    kps_out[j] = pts_inp[j] / cfg.down_ratio

            # Match this detection to a GT object by 2D keypoint distance so
            # tracking targets are prediction - current (dataset_combined:740-760).
            # The detector saw the FLIPPED frame, so flip + flip-idx-swap the
            # GT cuboids before matching (dataset_combined.py:510-517) — raw
            # GT coords against flipped detections would mismatch objects.
            best_name, best_d = None, np.inf
            for ann in p_anns.get("objects", []):
                try:
                    gt = np.asarray(
                        ann["projected_cuboid"], np.float64
                    )[1:9].copy()
                except (KeyError, TypeError):
                    continue
                if flipped:
                    gt[:, 0] = width - gt[:, 0] - 1
                    for a, bsw in FLIP_IDX:
                        ia, ib = a - 1, bsw - 1
                        gt[[ia, ib]] = gt[[ib, ia]]
                d = np.linalg.norm(gt - pts[: len(gt)], axis=1).mean()
                if d < best_d:
                    best_d, best_name = d, ann.get("name", "")
            if best_name is not None:
                prev_tracks[best_name] = (
                    ct / cfg.down_ratio, kps_out, ~np.isnan(kps_out[:, 0]),
                )
        return pre_img, pre_hm, pre_hm_hp, prev_tracks

    def _attach_tracking_targets(self, objects, kept_anns, prev_tracks):
        """Set tracking / prev-keypoint data on current ObjectAnnotations
        (dataset_combined.py:1103-1137). `kept_anns` is PAIRED with `objects`
        (filtered annotations excluded — zipping against the raw json list
        would attach targets under the wrong object whenever one was skipped).

        The per-joint tracking_hp offsets are computed in render_targets per
        symmetry slice (the reference computes prev − pt_int inside the
        id_symmetry loop) from `tracking_kps_pre`; the mask requires the PREV
        keypoint to exist (pts_mask_pre, dataset_combined.py:1115-1118), not
        current-frame visibility."""
        for obj, ann in zip(objects, kept_anns):
            name = ann.get("name", "")
            if name not in prev_tracks:
                continue
            ct_pre, kps_pre, pre_mask = prev_tracks[name]
            ct_int = obj.center.astype(np.int32)
            obj.tracking = (np.asarray(ct_pre) - ct_int).astype(np.float32)
            obj.tracking_kps_pre = np.nan_to_num(
                np.asarray(kps_pre, np.float32), nan=0.0
            )
            obj.tracking_kps_pre_mask = np.asarray(pre_mask, bool)


    # -------------------------------------------------------------- annotation
    def _symmetry_projections(self, ann, width, height, proj_matrix) -> np.ndarray:
        """[S, 9, 2] keypoint projections over symmetry rotations
        (dataset_combined.py:979-1012)."""
        cfg = self.cfg
        s = cfg.num_symmetry
        pts0 = np.asarray(ann["projected_cuboid"], np.float64)[:9]
        if s <= 1 or proj_matrix is None or "keypoints_3d" not in ann:
            return pts0[None]

        from scipy.spatial.transform import Rotation as R

        theta = 2 * np.pi / s
        m_o2c = np.eye(4)
        m_o2c[:3, :3] = R.from_quat(ann["quaternion_xyzw"]).as_matrix()
        m_o2c[:3, 3] = ann["location"]
        m_c2o = np.linalg.inv(m_o2c)
        kp3d = np.asarray(ann["keypoints_3d"], np.float64)[:9]

        out = []
        for i in range(s):
            m_r = rotation_y_matrix(theta * i)
            m_trans = proj_matrix @ m_o2c @ m_r @ m_c2o
            pts = []
            for p in kp3d:
                hom = m_trans @ np.append(p, 1.0)
                hom = hom / hom[3]
                # OpenGL viewport mapping: note the reference's (height, width)
                # ordering then (x=vp[1], y=vp[0]) swap (dataset_combined.py:1004-1009).
                vx = (hom[1] + 1.0) / 2.0 * width
                vy = (hom[0] + 1.0) / 2.0 * height
                pts.append([int(vx), int(vy)])
            out.append(pts)
        return np.asarray(out, np.float64)

    def _build_annotation(
        self, ann, width, height, flipped, trans_output, proj_matrix, rot=0.0
    ) -> Optional[ObjectAnnotation]:
        cfg = self.cfg
        res_w, res_h = cfg.output_w, cfg.output_h
        try:
            all_sym = self._symmetry_projections(ann, width, height, proj_matrix)
        except Exception:
            return None

        s = all_sym.shape[0]
        kp_list = np.zeros((s, 8, 2), np.float32)
        vis_list = np.zeros((s, 8), bool)
        centers, sizes = [], []

        for si in range(s):
            pts9 = all_sym[si].copy()
            ct_ori, pts = pts9[0], pts9[1:]

            vis = (
                (pts[:, 0] < width) & (pts[:, 0] >= 0)
                & (pts[:, 1] >= 0) & (pts[:, 1] < height)
            )
            if flipped:
                pts[:, 0] = width - pts[:, 0] - 1
                for a, b in FLIP_IDX:
                    ia, ib = a - 1, b - 1
                    pts[[ia, ib]] = pts[[ib, ia]]
                    vis[[ia, ib]] = vis[[ib, ia]]

            pts_out = affine_transform_points(pts, trans_output)
            bbox = np.array(
                [pts_out[:, 0].min(), pts_out[:, 1].min(),
                 pts_out[:, 0].max(), pts_out[:, 1].max()]
            )
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, res_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, res_h - 1)
            w_box, h_box = bbox[2] - bbox[0], bbox[3] - bbox[1]

            # Visibility filter (dataset_combined.py:1040-1046): flags are
            # 2 = visible, 1 = labeled-but-not — pts[:, 2].sum() over 8
            # keypoints is nvis·2 + (8−nvis)·1 = nvis + 8, so "<= 12" drops
            # out-of-center objects with 4 or fewer visible keypoints.
            if ct_ori[0] >= width or ct_ori[0] < 0 or ct_ori[1] < 0 or ct_ori[1] >= height:
                if vis.sum() + 8 <= 12:
                    return None
            # Zero-area boxes pass when the crop is rotated
            # ("(h > 0 and w > 0) or (rot != 0)", dataset_combined.py:1045).
            if not ((w_box > 0 and h_box > 0) or rot != 0):
                return None

            kp_list[si] = pts_out
            vis_list[si] = vis
            centers.append([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
            sizes.append([w_box, h_box])

        try:
            # objectron_pb.frame_to_ndds_dict legitimately emits objects
            # without 'scale' (pb Object lacking rotation) — treat as a
            # filtered annotation, not a loader-worker crash.
            scale = np.abs(np.asarray(ann["scale"], np.float64))
        except (KeyError, TypeError, ValueError):
            return None
        if scale.shape != (3,) or not float(scale[1]):
            return None
        rel_scale = scale / scale[1]
        return ObjectAnnotation(
            center=np.asarray(centers[0], np.float32),
            size=np.asarray(sizes[0], np.float32),
            keypoints=kp_list,
            keypoints_visible=vis_list,
            scale_3d=rel_scale.astype(np.float32),
        )


def collate_filtered(samples: Sequence[Optional[dict]]) -> Optional[Dict[str, np.ndarray]]:
    """Drop None samples; None for an empty batch (dataset_factory.py:8-14)."""
    good = [s for s in samples if s is not None]
    if not good:
        return None
    return {k: np.stack([s[k] for s in good]) for k in good[0]}
