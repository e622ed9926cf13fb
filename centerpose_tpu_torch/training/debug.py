"""Train-time debug rendering: pred/GT blends for the logger.

Parity target: `ObjectPoseTrainer.debug` (src/lib/trains/object_pose.py:218-401) —
decode the raw head maps, then emit the reference's canvas set for the first
sample of the batch:

  out_hm_pred / out_hm_gt       center heatmap blends
  out_hmhp_pred / out_hmhp_gt   keypoint heatmap blends (per-joint colors)
  out_img_pred                  decoded bboxes + cuboid wireframes + scale text
                                (+ tracking / tracking_hp arrows when present)
  out_img_gt                    the same drawn from the GT targets
  out_pred_gt_blend             pred (red) and GT (green) wireframes together
  pre_hm / pre_hmhp             previous-frame heatmap blends (tracking task)

GT boxes are reconstructed from the rendered target tensors (ind/wh/hps/...)
rather than a packed `gt_det` side-channel — same content, one source of truth.

The PyTorch package's twin of `centerpose_tpu/training/debug.py`: numpy in,
numpy canvases out, the decode through this package's
`ops/decode.py::object_pose_decode` on CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD, CenterPoseConfig
from centerpose_tpu_torch.ops.decode import object_pose_decode
from centerpose_tpu_torch.utils.debugger import Debugger

_CENTER_THRESH = 0.1  # opts.py --center_thresh default


def _denormalize(img: np.ndarray) -> np.ndarray:
    mean = np.array(DATA_MEAN, np.float32)
    std = np.array(DATA_STD, np.float32)
    return ((img * std + mean) * 255.0).clip(0, 255).astype(np.uint8)


def _gt_items(batch: Dict[str, np.ndarray], cfg: CenterPoseConfig, i: int,
              choice: int):
    """Reconstruct per-object GT rows from the target tensors (the reference
    packs the same fields into meta['gt_det'], dataset_combined.py:1062-1157)."""
    w = cfg.output_w
    items = []
    for m in range(cfg.max_objs):
        if batch["reg_mask"][i, choice, m] <= 0:
            continue
        ind = int(batch["ind"][i, choice, m])
        ct = np.array([ind % w, ind // w], np.float64)
        ct = ct + batch["reg"][i, choice, m]
        bw, bh = np.asarray(batch["wh"][i, choice, m], np.float64)
        kps = np.asarray(batch["hps"][i, choice, m], np.float64).reshape(-1, 2)
        vis = np.asarray(batch["hps_mask"][i, choice, m]).reshape(-1, 2)[:, 0] > 0
        kps = np.where(vis[:, None], kps + np.floor(ct), -10000.0)
        item = {
            "bbox": np.array([ct[0] - bw / 2, ct[1] - bh / 2,
                              ct[0] + bw / 2, ct[1] + bh / 2]),
            "ct": ct,
            "kps": kps,
            "scale": np.asarray(batch["scale"][i, choice, m], np.float64),
        }
        if "tracking" in batch and batch.get("tracking_mask") is not None:
            if batch["tracking_mask"][i, choice, m] > 0:
                item["tracking"] = np.asarray(
                    batch["tracking"][i, choice, m], np.float64)
        if "tracking_hp" in batch:
            mask = np.asarray(
                batch["tracking_hp_mask"][i, choice, m]).reshape(-1, 2)[:, 0] > 0
            item["tracking_hp"] = np.asarray(
                batch["tracking_hp"][i, choice, m], np.float64).reshape(-1, 2)
            item["tracking_hp_mask"] = mask
        items.append(item)
    return items


def render_train_debug(
    batch: Dict[str, np.ndarray],
    outputs: Dict[str, np.ndarray],
    cfg: CenterPoseConfig,
    choice: int = 0,
    center_thresh: float = _CENTER_THRESH,
) -> Dict[str, np.ndarray]:
    """Return the reference's named debug canvases for batch sample 0.
    `batch`: numpy arrays with the wire encoding undone
    (`training/trainer.py::decode_wire_np`); `outputs`: the network's NHWC
    head maps of that batch, numpy."""
    batch = {k: np.asarray(v) for k, v in batch.items() if not k.startswith("meta")}
    outputs = {k: np.asarray(v, np.float32) for k, v in outputs.items()}

    dets = object_pose_decode(
        {k: torch.tensor(v) for k, v in outputs.items()},
        k=cfg.K, rep_mode=cfg.rep_mode, inference=False, fit_gaussian=False,
        apply_sigmoid=True,
    )
    dets = {k: v.numpy() for k, v in dets.items()}
    r = cfg.down_ratio
    for key in ("bboxes", "kps", "tracking", "tracking_hp"):
        if key in dets:
            dets[key] = dets[key] * r

    i = 0
    dbg = Debugger(down_ratio=r)
    img = _denormalize(batch["input"][i])

    sig = 1.0 / (1.0 + np.exp(-outputs["hm"][i]))
    dbg.add_blend_img(img, dbg.gen_colormap(sig, img.shape[:2]), "out_hm_pred")
    dbg.add_blend_img(
        img, dbg.gen_colormap(batch["hm"][i, choice], img.shape[:2]), "out_hm_gt")
    if "hm_hp" in outputs:
        sig_hp = 1.0 / (1.0 + np.exp(-outputs["hm_hp"][i]))
        dbg.add_blend_img(
            img, dbg.gen_colormap_hp(sig_hp, img.shape[:2]), "out_hmhp_pred")
        dbg.add_blend_img(
            img, dbg.gen_colormap_hp(batch["hm_hp"][i, choice], img.shape[:2]),
            "out_hmhp_gt")

    if "pre_img" in batch:
        pre_img = _denormalize(batch["pre_img"][i])
        if "pre_hm" in batch:
            dbg.add_blend_img(
                pre_img, dbg.gen_colormap(batch["pre_hm"][i], pre_img.shape[:2]),
                "pre_hm")
        if "pre_hm_hp" in batch:
            dbg.add_blend_img(
                pre_img,
                dbg.gen_colormap_hp(batch["pre_hm_hp"][i], pre_img.shape[:2]),
                "pre_hmhp")

    # Predictions (object_pose.py:286-327).
    dbg.add_img(img, "out_img_pred")
    for k in range(dets["scores"].shape[1]):
        if dets["scores"][i, k, 0] <= center_thresh:
            continue
        dbg.add_coco_bbox(dets["bboxes"][i, k], 0, dets["scores"][i, k, 0],
                          img_id="out_img_pred")
        dbg.add_coco_hp(dets["kps"][i, k], img_id="out_img_pred")
        if "obj_scale" in dets:
            dbg.add_obj_scale(dets["bboxes"][i, k], dets["obj_scale"][i, k],
                              img_id="out_img_pred")
        ct = [(dets["bboxes"][i, k, 0] + dets["bboxes"][i, k, 2]) / 2,
              (dets["bboxes"][i, k, 1] + dets["bboxes"][i, k, 3]) / 2]
        if "tracking" in dets:
            for canvas in ("out_img_pred", "pre_hm"):
                if canvas in dbg.imgs:
                    dbg.add_arrow(ct, dets["tracking"][i, k], canvas,
                                  c=(255, 255, 0))
        if "tracking_hp" in dets:
            kp = dets["kps"][i, k].reshape(-1, 2)
            thp = dets["tracking_hp"][i, k].reshape(-1, 2)
            for jj in range(kp.shape[0]):
                if kp[jj, 0] == 0 and kp[jj, 1] == 0:
                    continue
                for canvas in ("out_img_pred", "pre_hmhp"):
                    if canvas in dbg.imgs:
                        dbg.add_arrow(kp[jj], thp[jj], canvas, c=(255, 0, 0))

    # Ground truth (object_pose.py:331-379).
    gt_items = _gt_items(batch, cfg, i, choice)
    dbg.add_img(img, "out_img_gt")
    for item in gt_items:
        bbox_r = np.asarray(item["bbox"]) * r
        dbg.add_coco_bbox(bbox_r, 0, 1.0, img_id="out_img_gt")
        kps_r = np.where(item["kps"] <= -10000, -10000.0, item["kps"] * r)
        dbg.add_coco_hp(kps_r, img_id="out_img_gt", pred_flag="gt")
        dbg.add_obj_scale(bbox_r, item["scale"], img_id="out_img_gt",
                          pred_flag="gt")
        if "tracking" in item:
            for canvas in ("out_img_gt", "pre_hm"):
                if canvas in dbg.imgs:
                    dbg.add_arrow(np.asarray(item["ct"]) * r,
                                  np.asarray(item["tracking"]) * r, canvas)
        if "tracking_hp" in item:
            for jj in range(item["tracking_hp"].shape[0]):
                if not item["tracking_hp_mask"][jj] or kps_r[jj, 0] <= -10000:
                    continue
                for canvas in ("out_img_gt", "pre_hmhp"):
                    if canvas in dbg.imgs:
                        dbg.add_arrow(kps_r[jj], item["tracking_hp"][jj] * r,
                                      canvas, c=(0, 255, 0))

    # Blended pred (red) vs GT (green) wireframes (object_pose.py:381-389).
    dbg.add_img(img, "out_pred_gt_blend")
    for k in range(dets["scores"].shape[1]):
        if dets["scores"][i, k, 0] > center_thresh:
            dbg.add_coco_hp(dets["kps"][i, k], img_id="out_pred_gt_blend")
    for item in gt_items:
        kps_r = np.where(item["kps"] <= -10000, -10000.0, item["kps"] * r)
        dbg.add_coco_hp(kps_r, img_id="out_pred_gt_blend", pred_flag="gt")

    return dbg.imgs


def save_train_debug(
    imgs: Dict[str, np.ndarray], debug_dir: str, iter_id,
) -> None:
    """PNG dump, reference naming `{iter}{canvas}.png` (debugger.py:356-359)."""
    import os

    from PIL import Image

    os.makedirs(debug_dir, exist_ok=True)
    for name, arr in imgs.items():
        Image.fromarray(arr).save(os.path.join(debug_dir, f"{iter_id}{name}.png"))
