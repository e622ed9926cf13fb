"""End-to-end CenterPose detector pipeline, counterpart of
`centerpose_tpu/inference/detector.py`: the image model and the
CenterPoseTrack video model.

Parity target: `BaseDetector.run` orchestration (src/lib/detectors/base_detector.py:
390-772) + `ObjectPoseDetector.{process,post_process,merge_outputs}`
(src/lib/detectors/object_pose.py:126-197) + `pnp_shell`
(src/lib/utils/pnp/cuboid_pnp_shell.py:11-93).

Stages:
  `pre`   host: crop window and meta; the warp itself runs on the device
          (`ops/resample.py`) in the usual fixed-resolution mode, on the host
          (numpy) in the multi-scale / fix_short / keep-resolution modes.
  `net`   device: warp → (tracking: previous-frame heatmap render) →
          network forward → sigmoid → decode, then ONE fetch of the decoded
          detections to the host.
  `post`  host: map coords back to image space (tiny, K×2 points).
  `merge` host: threshold + soft-NMS over <K boxes; for tracking, the
          inverse-variance fusion of the two keypoint estimates.
  `pnp`   device: batched DLT/EPnP+LM PnP over all surviving boxes at once.
  `track` host + device: association, Kalman filter and scale pool on the
          host, then one batched re-PnP of every track on the device
          (`tracking/tracker.py`).

Per-stage wall-clock timing is reported with the reference's stage names
(tot/pre/net/dec/post/merge/pnp/track — demo.py:54-57).

Tracking (`cfg.tracking_task`, the dla_34 CenterPoseTrack model) runs one
frame per `run` call. The first frame of a video warps on the host, because
there is no previous frame yet; every later frame sends the uint8 frame to the
device, where warp, previous-frame render, network and decode run without a
fetch in between. `cfg.refined_kalman` puts the CenterPose + Kalman baseline
tracker behind the image model. Not ported: the debug canvases
(`render_debug`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD, CenterPoseConfig
from centerpose_tpu_torch.geometry.affine import get_affine_transform, warp_affine
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.inference.nms import soft_nms
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops.decode import object_pose_decode
from centerpose_tpu_torch.ops.pnp import PnPResult, solve_pnp_batch_padded
from centerpose_tpu_torch.ops.resample import (
    axis_aligned,
    preprocess_on_device,
    warp_axis_aligned_batch,
)
from centerpose_tpu_torch.tracking.render import (
    render_inputs,
    render_maps,
    render_previous_heatmaps,
)

# Post-process std scale factor (src/lib/utils/post_process.py:15).
_STD_COEFFICIENT = 0.32

# Category-specific visibility rejection (cuboid_pnp_shell.py:59-72).
_NUM_NOT_VISIBLE_THRESH = {
    "book": 6, "chair": 6, "cereal_box": 6,
    "camera": 3, "bottle": 3, "cup": 3,
}

DEFAULT_CAMERA = np.array(
    [[663.0287679036459, 0, 300.2775065104167],
     [0, 663.0287679036459, 395.00066121419275],
     [0, 0, 1]]
)  # demo.py:141-144


def pnp_shell_epilogue(cuboid, rotation_gl, translation_gl, projected,
                       width, height, category, kps):
    """pnp_shell epilogue (cuboid_pnp_shell.py:31-93): GL pose → 9-point
    camera-frame corners + width/height-normalized projections, category
    visibility rejection, normalized source keypoints.

    Returns (proj9, pts3d, kps9, ok) — pts3d/proj9 are computed even when
    `ok` is False so callers can keep attaching them to rejected detections."""
    pts3d = cuboid @ rotation_gl.T + translation_gl
    pts3d = np.vstack([pts3d.mean(axis=0, keepdims=True), pts3d])
    proj9 = np.vstack(
        [projected.mean(axis=0, keepdims=True), projected]
    ).astype(np.float64)
    proj9[:, 0] /= width
    proj9[:, 1] /= height

    ok = True
    thresh = _NUM_NOT_VISIBLE_THRESH.get(category)
    if thresh is not None:
        out = (
            (proj9[:, 0] < 0) | (proj9[:, 0] > 1)
            | (proj9[:, 1] < 0) | (proj9[:, 1] > 1)
        ).sum()
        if out >= thresh:
            ok = False
    if not (0 < proj9[0, 0] < 1 and 0 < proj9[0, 1] < 1):
        ok = False

    kps9 = np.asarray(kps, np.float64).reshape(-1, 2)
    kps9 = np.vstack([kps9.mean(axis=0, keepdims=True), kps9])
    kps9[:, 0] /= width
    kps9[:, 1] /= height
    return proj9, pts3d, kps9, ok


def _fetch(dets: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """All decode outputs to the host in ONE transfer: they are all float32
    [B, K, n], so they travel as one concatenated tensor."""
    keys = list(dets)
    widths = [dets[k_].shape[-1] for k_ in keys]
    flat = torch.cat([dets[k_] for k_ in keys], dim=-1).cpu().numpy()
    out, off = {}, 0
    for k_, n in zip(keys, widths):
        out[k_] = flat[..., off:off + n]
        off += n
    return out


class Detector:
    """Single-category CenterPose detector (image model or tracking model).

    Setting `cfg` on a tracking detector also sets the tracker's (the JAX
    package's detector leaves the tracker on the old config; its
    `scripts/bench_e2e.py` swaps the config and so never spawned tracks)."""

    def __init__(
        self,
        config: CenterPoseConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        self.device = torch.device(device)
        self.tracker = None
        if config.tracking_task:
            from centerpose_tpu_torch.tracking.tracker import Tracker

            self.tracker = Tracker(config, self.device)
        elif config.refined_kalman:
            # CenterPose + KF baseline (base_detector.py:664-665).
            from centerpose_tpu_torch.tracking.tracker_baseline import TrackerBaseline

            self.tracker = TrackerBaseline(config, self.device)
        self.cfg = config
        self.pre_images: Optional[torch.Tensor] = None   # previous frame, NHWC
        self.model = create_model(
            config, self.device, generator=torch.Generator().manual_seed(seed)
        )
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.mean = np.array(DATA_MEAN, np.float32).reshape(1, 1, 3)
        self.std = np.array(DATA_STD, np.float32).reshape(1, 1, 3)

    @property
    def cfg(self) -> CenterPoseConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, config: CenterPoseConfig) -> None:
        self._cfg = config
        if self.tracker is not None:
            self.tracker.cfg = config

    # ------------------------------------------------------------------ net+dec
    @torch.no_grad()
    def _forward_decode(self, images: torch.Tensor, pre_img=None, pre_hm=None,
                        pre_hm_hp=None):
        """Normalised NHWC float images (and, for the tracking model, the
        NHWC previous-frame inputs) → (head maps, decoded detections)."""
        cfg = self.cfg
        outputs = self.model(images, pre_img, pre_hm, pre_hm_hp)
        dets = object_pose_decode(
            outputs,
            k=cfg.K,
            rep_mode=cfg.rep_mode,
            inference=True,
            # decode.py:222: gaussian fitting runs for tracking / refined-KF / rep 2.
            fit_gaussian=cfg.tracking_task or cfg.refined_kalman or cfg.rep_mode == 2,
            apply_sigmoid=True,
            balance_coefficient=cfg.balance_coefficient,
            hm_hp_thresh=cfg.hm_hp_thresh,
        )
        return outputs, dets

    @torch.no_grad()
    def _forward_decode_raw(self, raw: torch.Tensor, transforms: torch.Tensor,
                            render_params=None):
        """uint8 frames + axis-aligned dst→src transforms in, decoded
        detections out: warp, normalisation, network and decode all on the
        device, nothing fetched in between. For the tracking model
        `render_params` (the host slot arrays of `tracking/render.py::
        render_inputs`) are rendered into the previous-frame heatmaps on the
        device between the warp and the network, whose previous-frame image
        is `self.pre_images`."""
        cfg = self.cfg
        images = warp_axis_aligned_batch(raw, transforms, cfg.input_h, cfg.input_w)
        pre = ()
        if render_params is not None:
            maps = render_maps(*render_params, cfg.input_h, cfg.input_w, self.device)
            pre = (self.pre_images, *(m.permute(0, 2, 3, 1) for m in maps))
        outputs, dets = self._forward_decode(images, *pre)
        return images, outputs, dets

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # ------------------------------------------------------------------ pre
    def pre_process(
        self, image: np.ndarray, input_meta: Optional[dict] = None,
        scale: float = 1.0, warp: bool = True,
    ):
        """All three testing modes of base_detector.pre_process (:91-148):

        - ``cfg.fix_short > 0``: short side → fix_short, long side rounded up to
          a multiple of 64; crop window spans the whole image anisotropically.
        - ``cfg.fix_res`` (the usual mode): warp-crop to (input_h, input_w). With
          ``scale != 1`` the image is first resized but the crop window keeps the
          ORIGINAL max(h, w) extent, so the object genuinely shrinks/grows on the
          input grid — true multi-scale testing, not a resample no-op.
        - keep-resolution: pad each (scaled) side to ``(dim | cfg.pad) + 1``.
        """
        cfg = self.cfg
        height, width = image.shape[:2]
        new_height, new_width = int(height * scale), int(width * scale)
        if scale != 1.0:
            from PIL import Image

            image = np.asarray(
                Image.fromarray(np.asarray(image, np.uint8)).resize(
                    (new_width, new_height)
                )
            )

        if cfg.fix_short > 0:
            # base_detector.py:100-108 — window in ORIGINAL-image units.
            if height < width:
                inp_h = cfg.fix_short
                inp_w = (int(width / height * cfg.fix_short) + 63) // 64 * 64
            else:
                inp_h = (int(height / width * cfg.fix_short) + 63) // 64 * 64
                inp_w = cfg.fix_short
            c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
            s = np.array([width, height], dtype=np.float32)
        elif cfg.fix_res:
            # base_detector.py:109-114 — center on the resized image, extent from
            # the original dims (multi-scale zoom).
            inp_h, inp_w = cfg.input_h, cfg.input_w
            c = np.array([new_width / 2.0, new_height / 2.0], dtype=np.float32)
            s = max(height, width) * 1.0
        else:
            # keep-res (base_detector.py:115-119).
            inp_h = (new_height | cfg.pad) + 1
            inp_w = (new_width | cfg.pad) + 1
            c = np.array([new_width // 2, new_height // 2], dtype=np.float32)
            s = np.array([inp_w, inp_h], dtype=np.float32)

        if warp:
            trans_input = get_affine_transform(c, s, 0, (inp_w, inp_h))
            inp = warp_affine(image.astype(np.float32), trans_input, (inp_w, inp_h))
            inp = (inp / 255.0 - self.mean) / self.std
            images = inp[None].astype(np.float32)  # NHWC
        else:
            # Device path: the warp happens on the device together with the
            # network (run(), _forward_decode_raw); only the meta is needed.
            images = None

        meta = {
            "c": c,
            "s": s,
            "height": height,
            "width": width,
            "out_height": inp_h // cfg.down_ratio,
            "out_width": inp_w // cfg.down_ratio,
            "camera_matrix": DEFAULT_CAMERA,
        }
        if input_meta:
            meta.update(input_meta)
        # The crop window actually used by the (host or device) warp.
        # input_meta may override 'c'/'s' for post_process coordinate mapping
        # (base_detector.py:139-147 merge semantics), but the warp geometry is
        # pinned to the locally computed window so both paths always agree.
        meta["_warp_c"], meta["_warp_s"] = c, s
        return images, meta

    # ------------------------------------------------------------------ post
    def post_process(
        self, dets: Dict[str, np.ndarray], meta: dict,
        min_score: Optional[float] = None,
    ) -> List[dict]:
        """object_pose_post_process (src/lib/utils/post_process.py:12-68).

        Vectorized over the K detections. `min_score` drops sub-threshold dets
        BEFORE the dict build — semantically free when the caller filters on
        the same threshold right after (merge_outputs does)."""
        c, s = meta["c"], meta["s"]
        w, h = meta["out_width"], meta["out_height"]
        # With anisotropic windows (fix_short / keep-res) `s` is a 2-vector; the
        # per-axis factor applies pairwise over flattened (x, y) sequences.
        scale_fac = np.asarray(s, np.float64) / max(w, h)

        scores = np.asarray(dets["scores"][0, :, 0], np.float64)
        if min_score is not None:
            idxs = np.nonzero(scores > min_score)[0]
        else:
            idxs = np.arange(scores.shape[0])
        if idxs.size == 0:
            return []

        def scale_xy(arr: np.ndarray) -> np.ndarray:
            a = np.asarray(arr, np.float64)
            return (a.reshape(a.shape[0], -1, 2) * scale_fac).reshape(a.shape)

        trans = get_affine_transform(c, s, 0, (w, h), inv=True)

        def tpreds(arr: np.ndarray) -> np.ndarray:
            """Batched transform_preds over [M, 2n] rows (sentinel-preserving,
            geometry/affine.py transform_preds)."""
            a = np.asarray(arr, np.float64).reshape(arr.shape[0], -1, 2)
            out = a @ trans[:, :2].T + trans[:, 2]
            invalid = (a[..., 0] == -10000) & (a[..., 1] == -10000)
            out[invalid] = -10000.0
            return out

        sel = {k_: np.asarray(v[0])[idxs] for k_, v in dets.items()}
        bboxes = tpreds(sel["bboxes"].reshape(idxs.size, 4)).reshape(idxs.size, 4)
        kps = tpreds(sel["kps"]).reshape(idxs.size, -1)
        kdm = tpreds(sel["kps_displacement_mean"]).reshape(idxs.size, -1)
        khm = tpreds(sel["kps_heatmap_mean"]).reshape(idxs.size, -1)
        kds = scale_xy(sel["kps_displacement_std"]) * _STD_COEFFICIENT
        khs = scale_xy(sel["kps_heatmap_std"]) * _STD_COEFFICIENT
        trk = scale_xy(sel["tracking"])
        trk_hp = scale_xy(sel["tracking_hp"])

        results = []
        for m, jdx in enumerate(idxs):
            bbox = bboxes[m]
            results.append({
                "score": float(scores[jdx]),
                "cls": int(sel["clses"][m, 0]),
                "obj_scale": np.array(sel["obj_scale"][m]),
                "obj_scale_uncertainty": np.array(sel["obj_scale_uncertainty"][m]),
                "kps_displacement_std": kds[m],
                "tracking": trk[m],
                "tracking_hp": trk_hp[m],
                "bbox": bbox,
                "ct": [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                "kps": kps[m],
                "kps_displacement_mean": kdm[m],
                "kps_heatmap_mean": khm[m],
                "kps_heatmap_std": khs[m],
                "kps_heatmap_height": sel["kps_heatmap_height"][m],
            })
        return results

    # ------------------------------------------------------------------ merge
    def merge_outputs(self, detections: List[dict]) -> List[dict]:
        """Threshold + soft-NMS (object_pose.py:184-197)."""
        results = [d for d in detections if d["score"] > self.cfg.vis_thresh]
        # soft-NMS when enabled OR merging multiple test scales (object_pose.py:193).
        if (self.cfg.nms or len(self.cfg.test_scales) > 1) and results:
            bboxes = np.stack([d["bbox"] for d in results])
            scores = np.array([d["score"] for d in results])
            keep = soft_nms(
                bboxes, scores, nt=0.5, method=2, threshold=self.cfg.vis_thresh
            )
            results = [results[i] for i in keep]
        return results

    # ------------------------------------------------------------------ fusion
    def gaussian_fusion(self, det: dict) -> None:
        """Inverse-variance fusion of displacement vs heatmap keypoints
        (base_detector.py:502-544). Mutates det in place."""
        hm_mean = det["kps_heatmap_mean"]
        hm_std = det["kps_heatmap_std"]
        d_mean = det["kps_displacement_mean"]
        d_std = det["kps_displacement_std"]

        heat_bad = (hm_mean < 0) | (hm_std < 0)
        if self.cfg.hps_uncertainty:
            var_d = np.maximum(d_std, 1e-9) ** -2.0
            var_h = np.maximum(hm_std, 1e-9) ** -2.0
            std_f = (var_d + var_h) ** -0.5
            mean_f = std_f ** 2 * (var_d * d_mean + var_h * hm_mean)
            std = np.where(heat_bad, d_std, std_f)
            mean = np.where(heat_bad, d_mean, mean_f)
        else:
            std_f = np.maximum(hm_std, 1e-9) / np.sqrt(2)
            var_h = np.maximum(hm_std, 1e-9) ** -2.0
            mean_f = std_f ** 2 * (var_h * d_mean + var_h * hm_mean)
            std = np.where(heat_bad, 20.0, std_f)
            mean = np.where(heat_bad, d_mean, mean_f)
        det["kps_fusion_mean"] = mean
        det["kps_fusion_std"] = std

    # ------------------------------------------------------------------ pnp
    def _pnp_points(self, det: dict) -> np.ndarray:
        """Assemble the PnP point set for a detection by rep_mode
        (base_detector.py:550-650)."""
        mode = self.cfg.rep_mode
        if mode in (0, 3, 4):
            return np.asarray(det["kps"], np.float64).reshape(-1, 2)
        if mode == 2:
            return self._pnp_points_sampled(det)
        # rep_mode 1 (default): 16 points interleaved [disp_j, heat_j].
        p1 = np.asarray(det["kps_displacement_mean"], np.float64).reshape(-1, 2)
        p2 = np.asarray(det["kps_heatmap_mean"], np.float64).reshape(-1, 2)
        return np.hstack([p1, p2]).reshape(-1, 2)

    def _pnp_points_sampled(self, det: dict, n_sample: int = 20) -> np.ndarray:
        """rep_mode 2 (base_detector.py:568-650): per joint, draw N_sample points
        from the displacement⊕heatmap estimate mixture (the reference fits a
        2-component GMM to samples of the two gaussians and resamples; sampling
        the mixture directly is statistically equivalent)."""
        rng = np.random.RandomState(0)
        d_mean = np.asarray(det["kps_displacement_mean"], np.float64).reshape(-1, 2)
        h_mean = np.asarray(det["kps_heatmap_mean"], np.float64).reshape(-1, 2)
        h_std = np.abs(
            np.asarray(det["kps_heatmap_std"], np.float64).reshape(-1, 2)
        )
        points = []
        for j in range(d_mean.shape[0]):
            if h_mean[j, 0] < -5000 or h_mean[j, 1] < -5000:
                # heatmap estimate missing → displacement-only, wide std.
                std = np.array([5.0, 5.0])
                pts = d_mean[j] + rng.randn(n_sample, 2) * np.sqrt(std)
            else:
                std = np.maximum(h_std[j], 1e-3)
                half = n_sample // 2
                pts = np.vstack(
                    [
                        h_mean[j] + rng.randn(half, 2) * np.sqrt(std),
                        d_mean[j] + rng.randn(n_sample - half, 2) * np.sqrt(std),
                    ]
                )
            points.append(pts)
        return np.vstack(points)

    def _pnp_assemble(self, results: List[dict]):
        """Point sets + normalized cuboids for a list of detections."""
        points = np.stack([self._pnp_points(d) for d in results])  # [M, N, 2]
        cuboids = np.stack(
            [
                cuboid_vertices(
                    np.asarray(d["obj_scale"], np.float64)
                    / max(float(d["obj_scale"][1]), 1e-9)
                )
                for d in results
            ]
        )
        return points, cuboids

    def _solve(self, points, cuboids, cameras) -> PnPResult:
        """Padded solve on the device, results fetched to host numpy."""
        res = solve_pnp_batch_padded(
            np.asarray(points, np.float32),
            np.asarray(cuboids, np.float32),
            np.asarray(cameras, np.float32),
            device=self.device,
        )
        return PnPResult(*[v.cpu().numpy() for v in res])

    def run_pnp_multi(
        self, results_list: List[List[dict]], metas: List[dict]
    ) -> List[List[tuple]]:
        """pnp_shell over MANY images' surviving boxes in ONE padded device
        solve (per-box intrinsics)."""
        counts = [len(r) for r in results_list]
        if sum(counts) == 0:
            return [[] for _ in results_list]
        pts, cubs, cams = [], [], []
        for results, meta in zip(results_list, metas):
            if not results:
                continue
            p, c = self._pnp_assemble(results)
            pts.append(p)
            cubs.append(c)
            cams.append(
                np.broadcast_to(
                    np.asarray(meta["camera_matrix"], np.float64),
                    (len(results), 3, 3),
                )
            )
        cuboids = np.concatenate(cubs)
        res = self._solve(np.concatenate(pts), cuboids, np.concatenate(cams))
        boxes_all, off = [], 0
        for results, meta, n in zip(results_list, metas, counts):
            if n == 0:
                boxes_all.append([])
                continue
            res_i = PnPResult(*[v[off:off + n] for v in res])
            boxes_all.append(
                self._pnp_consume(results, cuboids[off:off + n], res_i, meta)
            )
            off += n
        return boxes_all

    def run_pnp(self, results: List[dict], meta: dict) -> List[tuple]:
        """Batched pnp_shell over all surviving boxes (cuboid_pnp_shell.py:11-93)."""
        if not results:
            return []
        points, cuboids = self._pnp_assemble(results)
        res = self._solve(points, cuboids, meta["camera_matrix"])
        return self._pnp_consume(results, cuboids, res, meta)

    def _pnp_consume(self, results, cuboids, res, meta) -> List[tuple]:
        """Host epilogue of pnp_shell: pose fields, visibility rejection."""
        cat = self.cfg.category
        boxes = []
        for m, det in enumerate(results):
            if not res.valid[m]:
                continue
            # OpenGL pose is the eval-facing result (cuboid_pnp_solver.py:234-239).
            location = res.translation_gl[m]
            quaternion = res.quaternion_gl[m]
            det["location"] = location.tolist()
            det["quaternion_xyzw"] = quaternion.tolist()
            det["projected_cuboid"] = res.projected[m]

            # 3D corners, normalized projections, visibility rejection
            # (pnp_shell:31-93).
            proj9, pts3d, kps9, ok = pnp_shell_epilogue(
                cuboids[m], res.rotation_gl[m], location, res.projected[m],
                meta["width"], meta["height"], cat, det["kps"],
            )
            det["kps_3d_cam"] = pts3d
            det["kps_pnp"] = proj9
            if not ok:
                continue
            boxes.append(
                (proj9, pts3d, np.array(det["obj_scale"]), kps9, det)
            )
        return boxes

    # ------------------------------------------------------------------ run
    def run(self, image: np.ndarray, meta_inp: Optional[dict] = None) -> Dict[str, Any]:
        cfg = self.cfg
        times = {"pre": 0.0, "net": 0.0, "post": 0.0}
        t0 = time.time()

        scales = (1.0,) if cfg.tracking_task else tuple(cfg.test_scales)
        detections = []
        meta = None
        for scale in scales:
            ts = time.time()
            # Device-warp path: the standard fix_res crop at scale 1 is
            # axis-aligned, so the raw uint8 frame goes to the device and the
            # warp (and for tracking the previous-frame render) runs there,
            # ahead of the network. Multi-scale / fix_short / keep-res runs
            # keep the host warp (non-standard windows); so does a tracking
            # video's FIRST frame (there is no previous frame to pass yet).
            fused = (
                scale == 1.0 and cfg.fix_res and cfg.fix_short <= 0
                and not (cfg.tracking_task and self.pre_images is None)
            )
            if fused:
                images, meta_s = self.pre_process(
                    image, meta_inp, scale=scale, warp=False
                )
                raw = self._to_device(np.asarray(image))[None]
                invs = self._to_device(
                    get_affine_transform(
                        meta_s["_warp_c"], meta_s["_warp_s"], 0,
                        (cfg.input_w, cfg.input_h), inv=True,
                    ).astype(np.float32)
                )[None]
            else:
                images, meta_s = self.pre_process(image, meta_inp, scale=scale)
            if scale == 1.0 or meta is None:
                meta = meta_s
            t1 = time.time()
            times["pre"] += t1 - ts

            if fused:
                render_params = None
                if cfg.tracking_task:
                    tracks = [] if cfg.empty_pre_hm else self.tracker.active_tracks()
                    render_params = render_inputs(tracks, meta_s, cfg)
                images_t, _, dets = self._forward_decode_raw(raw, invs, render_params)
            else:
                images_t = self._to_device(images)
                extra = ()
                if cfg.tracking_task:
                    extra = self._tracking_inputs(images_t, meta_s)
                _, dets = self._forward_decode(images_t, *extra)
            dets = _fetch(dets)  # one transfer; it also waits for the device
            t2 = time.time()
            times["net"] += t2 - t1

            scale_dets = self.post_process(dets, meta_s,
                                           min_score=cfg.vis_thresh)
            if scale != 1.0:
                # Coordinates back to the unscaled image (object_pose.py:174-179).
                for det in scale_dets:
                    for key in (
                        "bbox", "kps", "kps_displacement_std", "tracking",
                        "tracking_hp", "kps_displacement_mean", "kps_heatmap_mean",
                    ):
                        if key in det:
                            det[key] = np.asarray(det[key], np.float64) / scale
                    det["ct"] = [
                        (det["bbox"][0] + det["bbox"][2]) / 2,
                        (det["bbox"][1] + det["bbox"][3]) / 2,
                    ]
            detections.extend(scale_dets)
            times["post"] += time.time() - t2
        times["dec"] = 0.0  # counted in `net`: no host round-trip between them
        t3 = time.time()

        results = self.merge_outputs(detections)
        t4 = time.time()
        times["merge"] = t4 - t3

        if cfg.tracking_task or cfg.refined_kalman:
            for det in results:
                self.gaussian_fusion(det)

        boxes = self.run_pnp(results, meta)
        t5 = time.time()
        times["pnp"] = t5 - t4

        if self.tracker is not None:
            results, boxes = self.tracker.step(results, boxes, meta)
            if cfg.tracking_task:
                self.pre_images = images_t
        t6 = time.time()
        times["track"] = t6 - t5
        times["tot"] = t6 - t0

        return {
            "results": results,
            "boxes": boxes,
            "meta": meta,
            "times": times,
        }

    def _tracking_inputs(self, images: torch.Tensor, meta: dict):
        """(pre_img, pre_hm, pre_hm_hp) for the host-warp path: the previous
        frame and the heatmaps rendered from the tracker's state
        (base_detector.py:150-388), on the device. On a video's first frame
        the frame is its own previous frame, and `meta["pre_dets"]` (ground
        truth of the first frame, for evaluation) seeds the tracker."""
        cfg = self.cfg
        if self.pre_images is None:
            self.pre_images = images
            if "pre_dets" in meta:
                self.tracker.init_track(meta)
        tracks = [] if cfg.empty_pre_hm else self.tracker.active_tracks()
        pre_hm, pre_hm_hp = render_previous_heatmaps(tracks, meta, cfg, self.device)
        return self.pre_images, pre_hm, pre_hm_hp

    def reset_tracking(self) -> None:
        """Forget the video: the next `run` is a first frame."""
        self.pre_images = None
        if self.tracker is not None:
            self.tracker.reset()

    def _batch_submit(self, images: List[np.ndarray],
                      metas: Optional[List[dict]] = None,
                      timing: bool = False) -> dict:
        """Device half of the batched path: build per-image metas/transforms,
        enqueue transfer → warp → net → decode (CUDA launches are
        asynchronous: this returns before the device finishes). Host
        post-processing happens in `_batch_finish`; keeping the two apart lets
        `run_batch_stream` overlap chunk N's host work with chunk N+1's device
        work."""
        cfg = self.cfg
        if cfg.tracking_task:
            raise ValueError("batched mode is for the image model; track a video with run()")
        metas = metas or [None] * len(images)
        t0 = time.time()

        pre_meta = []
        inv_transforms = []
        for img, m in zip(images, metas):
            height, width = img.shape[:2]
            c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
            s = max(height, width) * 1.0
            meta = {
                "c": c, "s": s, "height": height, "width": width,
                "out_height": cfg.input_h // cfg.down_ratio,
                "out_width": cfg.input_w // cfg.down_ratio,
                "camera_matrix": DEFAULT_CAMERA,
            }
            if m:
                meta.update(m)
            pre_meta.append(meta)
            inv_transforms.append(
                get_affine_transform(c, s, 0, (cfg.input_w, cfg.input_h), inv=True)
            )
        fused = (
            len({im.shape for im in images}) == 1
            and axis_aligned(inv_transforms)
        )
        if fused:
            # uint8 transfer → separable warp → net → decode.
            raw = self._to_device(np.stack(images))
            invs = self._to_device(np.stack(inv_transforms).astype(np.float32))
            t1 = time.time()
            _, _, dets = self._forward_decode_raw(raw, invs)
        else:
            batch = preprocess_on_device(
                images, inv_transforms, cfg.input_h, cfg.input_w, self.device
            )
            if timing and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # `pre` ends with the warp
            t1 = time.time()
            _, dets = self._forward_decode(batch)
        return {"dets": dets, "pre_meta": pre_meta, "t0": t0, "t1": t1}

    def _batch_finish(self, handle: dict, timing: bool = False
                      ) -> List[Dict[str, Any]]:
        """Host half: fetch decode outputs, per-image post/merge, one padded
        PnP solve for the whole batch."""
        cfg = self.cfg
        pre_meta = handle["pre_meta"]
        t0, t1 = handle["t0"], handle["t1"]
        dets = _fetch(handle["dets"])  # one transfer for all decode outputs
        t2 = time.time()

        times = {"pre": t1 - t0, "net": t2 - t1, "post": 0.0, "merge": 0.0,
                 "pnp": 0.0}
        results_list = []
        for i, meta in enumerate(pre_meta):
            ts = time.time()
            dets_i = {k_: v[i : i + 1] for k_, v in dets.items()}
            # Sub-threshold dets never survive merge_outputs — drop them
            # before the per-det dict build.
            detections = self.post_process(dets_i, meta,
                                           min_score=cfg.vis_thresh)
            tp = time.time()
            results_list.append(self.merge_outputs(detections))
            tm = time.time()
            times["post"] += tp - ts
            times["merge"] += tm - tp

        # ONE padded PnP solve for the whole batch (per-box intrinsics).
        tq0 = time.time()
        boxes_list = self.run_pnp_multi(results_list, pre_meta)
        times["pnp"] = time.time() - tq0

        outs = []
        for results, boxes, meta in zip(results_list, boxes_list, pre_meta):
            out = {"results": results, "boxes": boxes, "meta": meta}
            if timing:
                out["times"] = times  # shared batch-level dict
            outs.append(out)
        times["tot"] = time.time() - t0
        return outs

    def run_batch(
        self, images: List[np.ndarray], metas: Optional[List[dict]] = None,
        timing: bool = False,
    ) -> List[Dict[str, Any]]:
        """Batched folder/offline inference: ONE warp+forward+decode over the
        whole batch, then per-image host post-processing and one batched PnP.

        timing=True adds a shared per-stage wall-clock dict under "times" in
        each output (pre/net/post/merge/pnp/tot for the WHOLE batch)."""
        return self._batch_finish(
            self._batch_submit(images, metas, timing=timing), timing=timing
        )

    def run_batch_stream(self, chunks, timing: bool = False):
        """Pipelined batched serving: generator over (images, metas) chunks
        that keeps ONE chunk in flight on the device — chunk N's host
        post/merge/PnP overlaps chunk N+1's transfer + warp+net+decode. Yields
        the same per-image output lists run_batch returns, in order."""
        pending = None
        for images, metas in chunks:
            handle = self._batch_submit(images, metas, timing=timing)
            if pending is not None:
                yield self._batch_finish(pending, timing=timing)
            pending = handle
        if pending is not None:
            yield self._batch_finish(pending, timing=timing)
