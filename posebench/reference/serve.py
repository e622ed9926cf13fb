"""The plain image pipeline of CenterPose serving, from uint8 frames to
poses, the reference `Detector.run_batch_stream` and `Detector.run` are
held against.

Stages, each written again here in plain PyTorch and NumPy (frozen copies
where named):

- warp: the fixed-resolution crop of `base_detector.pre_process` (centre,
  scale = the long side, no rotation) as a bilinear 4-corner gather with a
  zero border, then the mean/std normalisation;
- network: `reference/net.py`, float32;
- decode: `reference/decode.py` (K top centres, rep_mode 1);
- post: the output-to-image affine on boxes and keypoints
  (`object_pose_post_process`), boxes at or under `vis_thresh` dropped;
- merge: soft-NMS (gaussian, sigma 0.5), a frozen copy of
  `centerpose_tpu_torch/inference/nms.py::soft_nms`;
- PnP: the 16 rep_mode-1 points of each box (displacement and heatmap
  keypoints interleaved), the cuboid of its scale over its height, the
  default camera, through `reference/pnp.py`.

`detect` returns, per image, the reference's own boxes and its dense head
maps; `forced` reads the reference at the cell a served box came from (the
program's choice of cell is judged by the reference's scores, as a served
token is judged by the reference's logits), and `solve` is the reference's
PnP of given keypoints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from posebench.reference.decode import object_pose_decode
from posebench.reference.pnp import solve_pnp_batch

DATA_MEAN = (0.408, 0.447, 0.470)
DATA_STD = (0.289, 0.274, 0.278)
DEFAULT_CAMERA = np.array([[663.0287679036459, 0, 300.2775065104167],
                           [0, 663.0287679036459, 395.00066121419275],
                           [0, 0, 1]])
INVALID = -10000.0


@dataclasses.dataclass
class Box:
    """One detection after merge, in image pixels."""
    ct: np.ndarray                   # [2] box centre
    score: float
    kps: np.ndarray                  # [16] keypoints after the heatmap blend
    disp: np.ndarray                 # [16] displacement keypoints
    projected: Optional[np.ndarray]  # [8, 2] reprojected cuboid, None if PnP failed
    scale: np.ndarray                # [3] the scale head's reading


def crop_transform(height: int, width: int, out: int, inverse: bool) -> np.ndarray:
    """2x3 affine of the fixed-resolution crop (no rotation): centre (w/2,
    h/2), scale max(h, w), to an `out` x `out` square; `inverse` maps the
    square's pixels back to the image's."""
    s = float(max(height, width))
    k = out / s
    fwd = np.array([[k, 0.0, out / 2.0 - k * width / 2.0],
                    [0.0, k, out / 2.0 - k * height / 2.0]])
    if not inverse:
        return fwd
    return np.array([[1 / k, 0.0, width / 2.0 - out / (2.0 * k)],
                     [0.0, 1 / k, height / 2.0 - out / (2.0 * k)]])


def warp(frames: torch.Tensor, out: int) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, out, out, 3]: bilinear,
    corners outside the frame count 0."""
    b, h, w, _ = frames.shape
    t = crop_transform(h, w, out, inverse=True)
    dev = frames.device
    grid = torch.arange(out, dtype=torch.float64, device=dev)
    sx = (t[0, 0] * grid + t[0, 2])[None, :].expand(out, out)
    sy = (t[1, 1] * grid + t[1, 2])[:, None].expand(out, out)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    img = frames.to(torch.float64)

    def corner(yi, xi):
        ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        v = img[:, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return v * ok

    res = (corner(y0, x0) * (1 - fy) * (1 - fx) + corner(y0, x0 + 1) * (1 - fy) * fx
           + corner(y0 + 1, x0) * fy * (1 - fx) + corner(y0 + 1, x0 + 1) * fy * fx)
    mean = torch.tensor(DATA_MEAN, dtype=torch.float64, device=dev)
    std = torch.tensor(DATA_STD, dtype=torch.float64, device=dev)
    return ((res / 255.0 - mean) / std).to(torch.float32)


def soft_nms(bboxes: np.ndarray, scores: np.ndarray, threshold: float, sigma: float = 0.5) -> List[int]:
    """Gaussian soft-NMS; the indices of the surviving boxes in greedy order."""
    n = len(scores)
    scores = scores.astype(np.float64).copy()
    alive = np.ones(n, bool)
    done = np.zeros(n, bool)
    order = []
    areas = (bboxes[:, 2] - bboxes[:, 0] + 1) * (bboxes[:, 3] - bboxes[:, 1] + 1)
    for _ in range(n):
        cand = alive & ~done
        if not cand.any():
            break
        i = int(np.argmax(np.where(cand, scores, -np.inf)))
        done[i] = True
        order.append(i)
        rest = alive & ~done
        if not rest.any():
            continue
        iw = np.maximum(np.minimum(bboxes[i, 2], bboxes[:, 2]) - np.maximum(bboxes[i, 0], bboxes[:, 0]) + 1, 0)
        ih = np.maximum(np.minimum(bboxes[i, 3], bboxes[:, 3]) - np.maximum(bboxes[i, 1], bboxes[:, 1]) + 1, 0)
        inter = iw * ih
        iou = inter / (areas[i] + areas - inter)
        scores = np.where(rest, scores * np.exp(-(iou * iou) / sigma), scores)
        alive &= ~(rest & (scores < threshold))
    return order


def _to_image(a: np.ndarray, t: np.ndarray) -> np.ndarray:
    """[M, 2n] output-map points through the 2x3 affine `t`, the -10000
    sentinel kept."""
    pts = a.reshape(a.shape[0], -1, 2).astype(np.float64)
    out = pts @ t[:, :2].T + t[:, 2]
    bad = (pts[..., 0] == INVALID) & (pts[..., 1] == INVALID)
    out[bad] = INVALID
    return out.reshape(a.shape)


def post_merge(dets: Dict[str, np.ndarray], i: int, frame_hw, out_res: int,
               vis_thresh: float) -> List[dict]:
    """Image `i`'s decoded detections above `vis_thresh`, in image pixels,
    after soft-NMS."""
    scores = dets["scores"][i, :, 0].astype(np.float64)
    idx = np.nonzero(scores > vis_thresh)[0]
    if idx.size == 0:
        return []
    t = crop_transform(frame_hw[0], frame_hw[1], out_res, inverse=True)
    bboxes = _to_image(dets["bboxes"][i, idx], t)
    kps = _to_image(dets["kps"][i, idx], t)
    disp = _to_image(dets["kps_displacement_mean"][i, idx], t)
    heat = _to_image(dets["kps_heatmap_mean"][i, idx], t)
    keep = soft_nms(bboxes, scores[idx], threshold=vis_thresh)
    return [{"score": float(scores[idx[m]]), "bbox": bboxes[m], "kps": kps[m], "disp": disp[m],
             "heat": heat[m], "scale": dets["obj_scale"][i, idx[m]].astype(np.float64)}
            for m in keep]


def cuboid(scale: np.ndarray) -> np.ndarray:
    """[8, 3] corners (binary order, x the high bit) of the cuboid of
    `scale` over its height."""
    size = scale / max(float(scale[1]), 1e-9)
    signs = np.array([[(1 if i & 4 else -1), (1 if i & 2 else -1), (1 if i & 1 else -1)]
                      for i in range(8)], np.float64)
    return signs * size / 2.0


def pnp(dets: List[dict], device, operands: torch.dtype = torch.float32) -> None:
    """Solve every detection's pose in one batch; sets `projected` (None
    where the solve fails). `operands`: the type the 2D points and the
    cuboids are rounded to before the float32 solve (the control's bf16)."""
    if not dets:
        return
    points = np.stack([np.stack([d["disp"].reshape(-1, 2), d["heat"].reshape(-1, 2)], 1).reshape(-1, 2)
                       for d in dets])
    cubs = np.stack([cuboid(d["scale"]) for d in dets])
    points, cubs = (torch.from_numpy(a).to(operands).to(torch.float32) for a in (points, cubs))
    res = solve_pnp_batch(points, cubs, DEFAULT_CAMERA, device=device)
    valid = res.valid.cpu().numpy()
    proj = res.projected.cpu().numpy().astype(np.float64)
    for m, d in enumerate(dets):
        d["projected"] = proj[m] if valid[m] else None


def boxes_of(dets: List[dict]) -> List[Box]:
    return [Box(ct=np.array([(d["bbox"][0] + d["bbox"][2]) / 2, (d["bbox"][1] + d["bbox"][3]) / 2]),
                score=d["score"], kps=d["kps"], disp=d["disp"], projected=d.get("projected"), scale=d["scale"])
            for d in dets]


@dataclasses.dataclass
class RefImage:
    """The reference's reading of one image: its own boxes, and the dense
    maps that let it be evaluated at any cell the program chose."""
    boxes: List[Box]
    heat: np.ndarray          # [oh, ow] sigmoid heatmap (clamped as decode clamps)
    hps: np.ndarray           # [oh, ow, 16] displacement offsets, output pixels
    reg: np.ndarray           # [oh, ow, 2] centre offsets
    scale: np.ndarray         # [oh, ow, 3]
    kth_score: float          # the K-th best peak's score: the least a served box may have
    hm_hp_max: float          # the largest keypoint-heatmap score


def forced(ref: RefImage, ct: np.ndarray, frame_hw, out_res: int, radius: int = 2):
    """The reference at the cell the program's box of centre `ct` (image
    pixels) came from: the cell within `radius` whose reference centre (cell
    + offset) lies nearest. Returns (cell (y, x), score, centre, 8
    displacement keypoints [16], scale), all in image pixels."""
    fwd = crop_transform(frame_hw[0], frame_hw[1], out_res, inverse=False)
    inv = crop_transform(frame_hw[0], frame_hw[1], out_res, inverse=True)
    cx, cy = fwd[:, :2] @ ct + fwd[:, 2]
    best = None
    for y in range(max(int(cy) - radius, 0), min(int(cy) + radius + 1, out_res)):
        for x in range(max(int(cx) - radius, 0), min(int(cx) + radius + 1, out_res)):
            d = np.hypot(x + ref.reg[y, x, 0] - cx, y + ref.reg[y, x, 1] - cy)
            if best is None or d < best[0]:
                best = (d, y, x)
    _, y, x = best
    centre = inv[:, :2] @ (np.array([x, y]) + ref.reg[y, x]) + inv[:, 2]
    pts = ref.hps[y, x].reshape(-1, 2) + [x, y]
    disp = (pts @ inv[:, :2].T + inv[:, 2]).reshape(-1)
    return (y, x), float(ref.heat[y, x]), centre, disp, ref.scale[y, x].astype(np.float64)


def solve(disps: Sequence[np.ndarray], scales: Sequence[np.ndarray], device) -> List[Optional[np.ndarray]]:
    """The reference's PnP of boxes given by their 8 displacement keypoints
    (image pixels) and scales, no keypoint-heatmap estimate: the reprojected
    cuboid, None where the solve fails."""
    dets = [{"disp": d, "heat": np.full(16, INVALID), "scale": s} for d, s in zip(disps, scales)]
    pnp(dets, device)
    return [d["projected"] for d in dets]


@torch.no_grad()
def detect(net, frames: np.ndarray, params: dict, device, block: int = 8,
           pnp_operands: torch.dtype = torch.float32) -> List[RefImage]:
    """The reference's reading of each uint8 frame. `params`: `input` (the
    square network input), `K`, `vis_thresh`, `hm_hp_thresh`,
    `balance_coefficient`; `pnp_operands` as `pnp`'s."""
    size = int(params["input"])
    k = int(params["K"])
    images = []
    found_all = []
    for s in range(0, len(frames), block):
        x = warp(torch.from_numpy(np.ascontiguousarray(frames[s:s + block])).to(device), size)
        out = net(x)
        dets = object_pose_decode(out, k=k, rep_mode=1, inference=True,
                                  fit_gaussian=False, apply_sigmoid=True,
                                  balance_coefficient=float(params["balance_coefficient"]),
                                  hm_hp_thresh=float(params["hm_hp_thresh"]))
        dets = {n: v.cpu().numpy() for n, v in dets.items()}
        heat = torch.sigmoid(out["hm"][..., 0]).clamp(1e-4, 1 - 1e-4).cpu().numpy()
        hm_hp_max = torch.sigmoid(out["hm_hp"]).amax(dim=(1, 2, 3)).cpu().numpy()
        maps = {n: out[n].cpu().numpy().astype(np.float64) for n in ("hps", "reg", "scale")}
        for i in range(x.shape[0]):
            found = post_merge(dets, i, frames.shape[1:3], size // 4, float(params["vis_thresh"]))
            found_all.append(found)
            images.append(RefImage(boxes=[], heat=heat[i], hps=maps["hps"][i],
                                   reg=maps["reg"][i], scale=maps["scale"][i],
                                   kth_score=float(dets["scores"][i, k - 1, 0]),
                                   hm_hp_max=float(hm_hp_max[i])))
    pnp([d for found in found_all for d in found], device, pnp_operands)      # one solve for the sample
    for image, found in zip(images, found_all):
        image.boxes = boxes_of(found)
    return images
