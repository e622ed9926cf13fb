"""Objectron training dataset (DOPE-style png+json pairs), the image model's.

The PyTorch package's own copy of the image-model branch of
`centerpose_tpu/data/dataset.py`; from the same files and RNG seed it gives
the same samples, key for key. Parity target: `ObjectPoseDataset`
(src/lib/datasets/dataset_combined.py:54-1207):
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
  * corrupt samples return None, filtered by the collate (dataset_factory.py:8-14).

Not here: the tracking model's samples (previous frame, noise simulation,
tracking targets); a `tracking_task` config raises, see ROADMAP.md queue A
item 5.

Compact wire (`compact_wire=True`, `train.py --wire compact`): images ship as
uint8 and heatmaps as uint8 in 1/255 steps, decoded on the device by
`training/trainer.py::decode_wire` (v / 255). Deliberate divergence from the
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
    """Map-style dataset; __getitem__ returns a dict of numpy arrays or None."""

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
        compact_wire: bool = False,
    ):
        if config.tracking_task:
            raise NotImplementedError(
                "the tracking model's samples (previous frame, noise simulation, tracking "
                "targets) are not ported yet; see ROADMAP.md queue A item 5"
            )
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

        targets = render_targets(objects, cfg)
        if self.compact_wire:
            for k in ("hm", "hm_hp"):
                if k in targets:
                    targets[k] = encode_heatmap(targets[k])
        targets["input"] = (
            inp if self.compact_wire else inp.astype(np.float32)
        )
        targets["meta"] = np.array([c[0], c[1], s, rot], np.float32)
        return targets

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
