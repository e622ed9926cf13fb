"""Previous-frame heatmaps for CenterPoseTrack, rendered on the device.

Counterpart of `centerpose_tpu/tracking/render.py`. Parity target:
`BaseDetector._get_additional_inputs` (src/lib/detectors/base_detector.py:
150-388), default modes render_hm_mode=1 (center gaussian scaled by the
detection score) and render_hmhp_mode=2 (keypoints from the KF-refined PnP
reprojection `kps_pnp_kf`, falling back to `kps_mean_kf`, with per-keypoint
confidence from the KF covariance). The reference rasterises object by object
on the CPU every frame; here the track state is packed into fixed
[max_tracks(*J)] slot arrays on the host (`render_inputs`, tiny numpy work)
and the full-resolution maps are rendered on the device by ONE batched
`geometry.gaussian.render_gaussians` call over the center map and the 8
keypoint maps (`render_maps`).
"""

from __future__ import annotations

import math
from typing import List, Tuple, Union

import numpy as np
import torch

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.geometry.affine import affine_transform_points, get_affine_transform
from centerpose_tpu_torch.geometry.gaussian import gaussian_radius, render_gaussians


def render_maps(hm_params, hp_params, h: int, w: int,
                device: Union[str, torch.device] = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of the JAX package's `_render_maps`: host slot arrays from
    `render_inputs` in, pre_hm [1, 1, h, w] and pre_hm_hp [1, J, h, w]
    (float32, on `device`) out. The center slots and the J keypoint slots go
    to the device as one packed array and render in one call."""
    centers, radii, amps, valid = hm_params
    hp_centers, hp_radii, hp_amps, hp_valid = hp_params
    j, mt = hp_radii.shape
    packed = np.empty((1 + j, mt, 5), np.float32)        # x, y, radius, amplitude, valid
    packed[0, :, :2], packed[1:, :, :2] = centers, hp_centers
    packed[0, :, 2], packed[1:, :, 2] = radii, hp_radii
    packed[0, :, 3], packed[1:, :, 3] = amps, hp_amps
    packed[0, :, 4], packed[1:, :, 4] = valid, hp_valid
    p = torch.from_numpy(packed).to(torch.device(device))
    maps = render_gaussians(p[..., :2], p[..., 2], p[..., 3], p[..., 4] > 0, h, w)
    return maps[None, :1], maps[None, 1:]


def render_inputs(
    tracks: List[dict], meta: dict, cfg: CenterPoseConfig
) -> Tuple[tuple, tuple]:
    """Host half of the pre-hm render: pack track state into fixed-shape
    [max_tracks(*J)] slot arrays (tiny numpy work) for `render_maps`."""
    inp_h, inp_w = cfg.input_h, cfg.input_w
    j = cfg.num_joints
    mt = cfg.max_tracks

    trans_input = get_affine_transform(
        meta["c"], meta["s"], 0, (inp_w, inp_h)
    )
    ori_w, ori_h = meta["width"], meta["height"]

    centers = np.zeros((mt, 2), np.float32)
    radii = np.zeros((mt,), np.float32)
    amps = np.zeros((mt,), np.float32)
    valid = np.zeros((mt,), bool)

    hp_centers = np.zeros((j, mt, 2), np.float32)
    hp_radii = np.zeros((j, mt), np.float32)
    hp_amps = np.zeros((j, mt), np.float32)
    hp_valid = np.zeros((j, mt), bool)

    for ti, det in enumerate(tracks[:mt]):
        bbox = np.asarray(det["bbox"], np.float64).reshape(2, 2)
        bbox = affine_transform_points(bbox, trans_input).reshape(4)
        bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, inp_w - 1)
        bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, inp_h - 1)
        h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if h <= 0 or w <= 0:
            continue
        radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(w)))))
        ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
        centers[ti] = ct.astype(np.int32)  # int center like draw_umich_gaussian
        radii[ti] = radius
        # render_hm_mode 1: amplitude = detection score.
        amps[ti] = float(det.get("score", 1.0))
        valid[ti] = True

        # Keypoint source: KF-refined PnP reprojection (render_hmhp_mode 2).
        if "kps_pnp_kf" in det:
            pts = np.asarray(det["kps_pnp_kf"])[1:, :2].astype(np.float64).copy()
            pts[:, 0] *= ori_w
            pts[:, 1] *= ori_h
        elif "kps_mean_kf" in det:
            pts = np.asarray(det["kps_mean_kf"]).reshape(-1, 2).astype(np.float64)
        else:
            pts = np.asarray(det["kps"], np.float64).reshape(-1, 2)

        vis = (
            (pts[:, 0] >= 0) & (pts[:, 0] < ori_w)
            & (pts[:, 1] >= 0) & (pts[:, 1] < ori_h)
        )
        pts_inp = affine_transform_points(pts, trans_input)
        inb = (
            (pts_inp[:, 0] >= 0) & (pts_inp[:, 0] < inp_w)
            & (pts_inp[:, 1] >= 0) & (pts_inp[:, 1] < inp_h)
        )

        if "kf" in det:
            conf = det["kf"].confidence(cfg.conf_border)
            # "Sometimes, heatmap is missing" (base_detector.py:317-324):
            # joints whose current-frame peak is absent carry the -10000
            # kps_heatmap_std sentinel (int radius <= 0) and are NOT drawn,
            # even though the KF still has confidence in them.
            std0 = np.asarray(
                det.get("kps_heatmap_std", np.ones(2 * j))
            ).reshape(-1, 2)[:, 0]
            conf = np.where(std0.astype(np.int32) > 0, conf, 0.0)
        else:
            conf = np.asarray(det.get("kps_heatmap_height", np.ones(j)))
        conf = np.clip(conf, 0.0, 1.0)

        for jj in range(j):
            if vis[jj] and inb[jj] and conf[jj] > 0:
                hp_centers[jj, ti] = pts_inp[jj].astype(np.int32)
                hp_radii[jj, ti] = radius
                hp_amps[jj, ti] = conf[jj]
                hp_valid[jj, ti] = True

    return (centers, radii, amps, valid), (hp_centers, hp_radii, hp_amps, hp_valid)


def render_previous_heatmaps(
    tracks: List[dict], meta: dict, cfg: CenterPoseConfig,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pre_hm [1, H, W, 1] and pre_hm_hp [1, H, W, 8] from tracker state, as
    NHWC views (the network's input layout) of the maps `render_maps` makes."""
    hm_params, hp_params = render_inputs(tracks, meta, cfg)
    hm, hm_hp = render_maps(hm_params, hp_params, cfg.input_h, cfg.input_w, device)
    return hm.permute(0, 2, 3, 1), hm_hp.permute(0, 2, 3, 1)
