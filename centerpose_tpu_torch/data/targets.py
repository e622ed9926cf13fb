"""GT target rendering for training (host-side numpy).

The package's own copy of `centerpose_tpu/data/targets.py`: the same arrays,
bit for bit.

Parity target: the target-writing tail of `ObjectPoseDataset.__getitem__`
(src/lib/datasets/dataset_combined.py:1062-1157): center/keypoint gaussians with the
IoU>=0.7 radius bound, center-relative displacement fields, sub-pixel offsets,
flattened indices, masks, and the leading num_symmetry axis on every tensor
(dataset_combined.py:369-397).

Layout (NHWC, as the JAX package; see training/losses.py):
  hm       [S, H, W, C]      hm_hp    [S, H, W, 8]
  ind      [S, M]            reg/wh/scale [S, M, D], reg_mask [S, M]
  hps      [S, M, 16]        hps_mask [S, M, 16]
  hp_ind   [S, 8M]           hp_offset [S, 8M, 2], hp_mask [S, 8M]
  tracking [S, M, 2] (+mask) tracking_hp [S, M, 16] (+mask)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.geometry.gaussian import draw_gaussian, gaussian_radius


@dataclasses.dataclass
class ObjectAnnotation:
    """One object's GT in OUTPUT-map coordinates, per symmetry copy.

    keypoints: [S, 8, 2] — rotated GT copies for symmetric categories
    (dataset_combined.py:979-1012); S=1 otherwise.
    """

    center: np.ndarray          # [2] (x, y)
    size: np.ndarray            # [2] (w, h) 2D box size
    keypoints: np.ndarray       # [S, 8, 2]
    keypoints_visible: np.ndarray  # [S, 8] bool/0-1
    scale_3d: np.ndarray        # [3] relative cuboid dims
    tracking: Optional[np.ndarray] = None      # [2] prev - cur center offset
    tracking_hp: Optional[np.ndarray] = None   # [8, 2] prev - cur kp offsets
    # Preferred tracking_hp inputs (dataset_combined.py:1108-1118): prev
    # keypoints in OUTPUT coords + existence mask; render_targets computes
    # prev − pt_int per symmetry slice. `tracking_hp` above is the legacy
    # pre-computed-offsets form (synthetic benches/tests).
    tracking_kps_pre: Optional[np.ndarray] = None       # [8, 2]
    tracking_kps_pre_mask: Optional[np.ndarray] = None  # [8] bool


def render_targets(
    objects: Sequence[ObjectAnnotation], cfg: CenterPoseConfig
) -> Dict[str, np.ndarray]:
    h, w = cfg.output_h, cfg.output_w
    s = cfg.num_symmetry
    m = cfg.max_objs
    j = cfg.num_joints
    c = cfg.num_classes

    hm = np.zeros((s, h, w, c), np.float32)
    hm_hp = np.zeros((s, h, w, j), np.float32)
    ind = np.zeros((s, m), np.int64)
    reg = np.zeros((s, m, 2), np.float32)
    reg_mask = np.zeros((s, m), np.float32)
    wh = np.zeros((s, m, 2), np.float32)
    scale = np.zeros((s, m, 3), np.float32)
    hps = np.zeros((s, m, 2 * j), np.float32)
    hps_mask = np.zeros((s, m, 2 * j), np.float32)
    hp_ind = np.zeros((s, j * m), np.int64)
    hp_offset = np.zeros((s, j * m, 2), np.float32)
    hp_mask = np.zeros((s, j * m), np.float32)
    tracking = np.zeros((s, m, 2), np.float32)
    tracking_mask = np.zeros((s, m), np.float32)
    tracking_hp = np.zeros((s, m, 2 * j), np.float32)
    tracking_hp_mask = np.zeros((s, m, 2 * j), np.float32)

    for k, obj in enumerate(objects[:m]):
        ct = np.asarray(obj.center, np.float32)
        ct_int = ct.astype(np.int32)
        if not (0 <= ct_int[0] < w and 0 <= ct_int[1] < h):
            continue
        bw, bh = float(obj.size[0]), float(obj.size[1])
        radius = max(0, int(gaussian_radius((np.ceil(bh), np.ceil(bw)))))
        kp_radius = radius

        n_sym = obj.keypoints.shape[0]
        for si in range(s):
            kp = obj.keypoints[min(si, n_sym - 1)]
            vis = obj.keypoints_visible[min(si, n_sym - 1)]

            draw_gaussian(hm[si, :, :, 0], ct_int, radius)
            ind[si, k] = ct_int[1] * w + ct_int[0]
            reg[si, k] = ct - ct_int
            reg_mask[si, k] = 1.0
            wh[si, k] = [bw, bh]
            scale[si, k] = obj.scale_3d

            for jj in range(j):
                if not vis[jj]:
                    continue
                pt = kp[jj]
                pt_int = pt.astype(np.int32)
                if not (0 <= pt_int[0] < w and 0 <= pt_int[1] < h):
                    continue
                hps[si, k, 2 * jj : 2 * jj + 2] = pt - ct_int
                hps_mask[si, k, 2 * jj : 2 * jj + 2] = 1.0
                draw_gaussian(hm_hp[si, :, :, jj], pt_int, kp_radius)
                hp_ind[si, k * j + jj] = pt_int[1] * w + pt_int[0]
                hp_offset[si, k * j + jj] = pt - pt_int
                hp_mask[si, k * j + jj] = 1.0
                if (
                    obj.tracking_kps_pre is not None
                    and obj.tracking_kps_pre_mask is not None
                    and obj.tracking_kps_pre_mask[jj]
                ):
                    # prev − cur per symmetry slice, masked by PREV-keypoint
                    # existence AND the current keypoint being rendered
                    # (dataset_combined.py:1108-1118 — the block is guarded
                    # by the same visibility/bounds conditions as hps_mask).
                    tracking_hp[si, k, 2 * jj : 2 * jj + 2] = (
                        np.asarray(obj.tracking_kps_pre[jj]) - pt_int
                    )
                    tracking_hp_mask[si, k, 2 * jj : 2 * jj + 2] = 1.0

            if obj.tracking is not None:
                tracking[si, k] = obj.tracking
                tracking_mask[si, k] = 1.0
            if obj.tracking_kps_pre is None and obj.tracking_hp is not None:
                tracking_hp[si, k] = np.asarray(obj.tracking_hp).reshape(-1)
                tracking_hp_mask[si, k] = np.repeat(vis.astype(np.float32), 2)

    out = {
        "hm": hm,
        "hm_hp": hm_hp,
        "ind": ind,
        "reg": reg,
        "reg_mask": reg_mask,
        "wh": wh,
        "scale": scale,
        "hps": hps,
        "hps_mask": hps_mask,
        "hp_ind": hp_ind,
        "hp_offset": hp_offset,
        "hp_mask": hp_mask,
    }
    if cfg.tracking:
        out.update(tracking=tracking, tracking_mask=tracking_mask)
    if cfg.tracking_hp:
        out.update(tracking_hp=tracking_hp, tracking_hp_mask=tracking_hp_mask)
    return out


def stack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([t[k] for t in samples]) for k in samples[0]}
