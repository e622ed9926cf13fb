"""One tracked frame of CenterPoseTrack in plain PyTorch and NumPy, the
reference the tracking cell holds `Detector.run` and its `Tracker` against.

`step(net, state, pre_frame, frame, cells, params, device)` steps the frame
from a kept state (`State`: the tracks, each a plain dict, and the id count)
through, in order:

- render: the previous frame's centre heatmap (a Gaussian of the box's
  radius at each track's box centre, its height the track's score) and its
  8 keypoint heatmaps (at the Kalman-refined re-PnP projection, else the
  filtered keypoints, else the detection's; their heights the Kalman
  confidences; not drawn where the frame's keypoint heatmap had no peak),
  as base_detector.py:150-388 renders them (render_hm_mode 1,
  render_hmhp_mode 2);
- warp: `reference/serve.py::warp`, of the frame and of the previous frame
  `pre_frame` (the video's frame before it, warped here as the program
  warped it a frame earlier); network: `reference/track_net.py`;
- decode: `reference/decode.py` with Gaussian fitting, plus the tracking
  model's gathers (keypoint and scale uncertainties, tracking offsets),
  read at `cells` (the output cells the program's detections came from, as
  serving reads the reference at the program's cells), and once more at the
  reference's own K best peaks, whose count `step` reports;
- post (image pixels, the uncertainties scaled by 0.32), merge
  (`vis_thresh`, soft-NMS: `reference/serve.py::soft_nms`), the fusion of
  each keypoint's displacement and heatmap estimates (inverse variance),
  PnP of the 16 rep_mode-1 points (`reference/pnp.py`) and pnp_shell's
  visibility test (the box centre's projection inside the image);
- the tracker (src/lib/utils/tracker.py:14-314): greedy association on
  centre + tracking offset under the area and class gates; for a matched
  track a Kalman predict and update per keypoint (state x, y, vx, vy; F with
  unit velocity coupling, Q = I, R = diag(std_x^2, std_y^2, R_v, R_v),
  Joseph form), the scale appended to its pool; new tracks above
  `new_thresh`; unmatched tracks aged, kept until `max_age`; each track's
  filtered keypoints, those whose confidence max(1 - b^(std - b1), 0) is
  under 0.15 set to -10000; the pooled scale (inverse variance); one PnP of
  the filtered keypoints and the pooled scale per track, a box where its
  mean confidence passes 0.25.

Departures from the published code, each the port's as well: the Kalman
filter as 8 independent 4-state blocks (the published 32-state filter is
block-diagonal: the same numbers); the Gaussians rendered densely over the
whole map and max-composited, not cut at the radius (the published window
drops tails under 1.1 % of a Gaussian's height); the Gaussian fit as its
moments (x the column axis); PnP as `reference/pnp.py` (DLT and EPnP
initialisers and Levenberg-Marquardt, not OpenCV).

Each track is a dict: `tracking_id`, `age`, `active`, `cls`, `score`, `ct`
[2], `bbox` [4], `kps` [16] (image pixels), `kps_heatmap_std` [16],
`obj_scale`, `obj_scale_uncertainty` [3], `kf` ((x [8, 4], P [8, 4, 4]) or
absent), `scale_pool` ([(scale, uncertainty)]), and after a step
`kps_mean_kf` [8, 2], `kps_std_kf` [16], `obj_scale_kf` [3], `kps_pnp_kf` [9,
2] (the projected cuboid over width and height, its centre first) and
`valid_points` (the valid keypoints of its re-PnP row).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from posebench.reference import decode as refdecode
from posebench.reference import serve as refserve
from posebench.reference.pnp import solve_pnp_batch

INVALID = -10000.0
STD_COEFFICIENT = 0.32
NUM_JOINTS = 8
_F = np.array([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
_I4 = np.eye(4)


@dataclasses.dataclass
class State:
    """What a frame starts from: the tracker's tracks and its id count."""
    tracks: List[dict]
    id_count: int


@dataclasses.dataclass
class Frame:
    """What one step gives: the state after it, the final boxes (`boxes`,
    the tracks whose re-PnP made a box), the reference's own count of
    detections that reached the tracker at its K best peaks (`own_dets`),
    and each forced cell's `choice_gap` (serving's, `posebench/checks.py`)."""
    state: State
    boxes: List[dict]
    own_dets: int
    choice_gaps: List[float]


# ---------------------------------------------------------------- Kalman
def kf_init(mean: np.ndarray, std: np.ndarray, tracking_hp: np.ndarray, r_velocity: float):
    x = np.stack([mean[0::2], mean[1::2], -tracking_hp[0::2], -tracking_hp[1::2]], axis=1)
    return x, _measurement_r(std, r_velocity)


def _measurement_r(std: np.ndarray, r_velocity: float) -> np.ndarray:
    r = np.zeros((NUM_JOINTS, 4, 4))
    r[:, 0, 0], r[:, 1, 1] = std[0::2] ** 2, std[1::2] ** 2
    r[:, 2, 2] = r[:, 3, 3] = r_velocity
    return r


def kf_step(kf, mean, std, tracking_hp, r_velocity):
    """Predict, then update with the fused keypoints and the velocity
    measured as minus the tracking_hp offset."""
    x, p = kf
    x = x @ _F.T
    p = _F @ p @ _F.T + _I4
    z = np.stack([mean[0::2], mean[1::2], -tracking_hp[0::2], -tracking_hp[1::2]], axis=1)
    r = _measurement_r(std, r_velocity)
    gain = p @ np.linalg.inv(p + r)
    x = x + np.einsum("jab,jb->ja", gain, z - x)
    ikh = _I4 - gain
    p = ikh @ p @ ikh.transpose(0, 2, 1) + gain @ r @ gain.transpose(0, 2, 1)
    return x, p


def kf_confidence(kf, conf_border) -> np.ndarray:
    b0, b1 = conf_border
    p = kf[1]
    std = np.sqrt(p[:, 0, 0] + p[:, 1, 1])
    base = math.exp(math.log(0.15) / (b0 - b1))
    with np.errstate(over="ignore"):
        return np.maximum(1.0 - base ** (std - b1), 0.0)


def pool_scale(pool) -> Tuple[np.ndarray, np.ndarray]:
    prec = sum(np.asarray(u, np.float64) ** -2 for _, u in pool)
    mean = sum(np.asarray(u, np.float64) ** -2 * np.asarray(m, np.float64) for m, u in pool) / prec
    return mean, prec ** -0.5


# ---------------------------------------------------------------- render
def gaussian_radius(h: float, w: float, min_overlap: float = 0.7) -> float:
    b1, c1 = h + w, w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + math.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2, c2 = 2 * (h + w), (1 - min_overlap) * w * h
    r2 = (b2 + math.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3, b3, c3 = 4 * min_overlap, -2 * min_overlap * (h + w), (min_overlap - 1) * w * h
    r3 = (b3 + math.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def _affine(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    return points @ t[:, :2].T + t[:, 2]


def render(tracks: Sequence[dict], frame_hw, size: int, params: dict, device):
    """(pre_hm [1, size, size, 1], pre_hm_hp [1, size, size, 8]) float32 on
    `device`."""
    h_img, w_img = frame_hw
    fwd = refserve.crop_transform(h_img, w_img, size, inverse=False)
    maps = np.zeros((1 + NUM_JOINTS, size, size))
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)

    def draw(m, cx, cy, radius, height):
        sigma = (2.0 * radius + 1.0) / 6.0
        g = height * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2))
        np.maximum(maps[m], g, out=maps[m])

    for t in tracks[: params["max_tracks"]]:
        box = _affine(np.asarray(t["bbox"], np.float64).reshape(2, 2), fwd).reshape(4)
        box[[0, 2]] = np.clip(box[[0, 2]], 0, size - 1)
        box[[1, 3]] = np.clip(box[[1, 3]], 0, size - 1)
        bh, bw = box[3] - box[1], box[2] - box[0]
        if bh <= 0 or bw <= 0:
            continue
        radius = max(0, int(gaussian_radius(math.ceil(bh), math.ceil(bw))))
        ct = np.array([(box[0] + box[2]) / 2, (box[1] + box[3]) / 2]).astype(np.int32)
        draw(0, ct[0], ct[1], radius, float(t["score"]))
        if t.get("kps_pnp_kf") is not None:
            pts = np.asarray(t["kps_pnp_kf"], np.float64)[1:, :2] * [w_img, h_img]
        elif t.get("kps_mean_kf") is not None:
            pts = np.asarray(t["kps_mean_kf"], np.float64).reshape(-1, 2)
        else:
            pts = np.asarray(t["kps"], np.float64).reshape(-1, 2)
        vis = (pts[:, 0] >= 0) & (pts[:, 0] < w_img) & (pts[:, 1] >= 0) & (pts[:, 1] < h_img)
        inp = _affine(pts, fwd)
        inb = (inp[:, 0] >= 0) & (inp[:, 0] < size) & (inp[:, 1] >= 0) & (inp[:, 1] < size)
        if "kf" in t:
            conf = kf_confidence(t["kf"], params["conf_border"])
            std0 = np.asarray(t["kps_heatmap_std"]).reshape(-1, 2)[:, 0]
            conf = np.where(std0.astype(np.int32) > 0, conf, 0.0)
        else:
            conf = np.ones(NUM_JOINTS)
        conf = np.clip(conf, 0.0, 1.0)
        for j in range(NUM_JOINTS):
            if vis[j] and inb[j] and conf[j] > 0:
                c = inp[j].astype(np.int32)
                draw(1 + j, c[0], c[1], radius, conf[j])
    t = torch.from_numpy(maps.astype(np.float32)).to(device)
    return t[0][None, :, :, None].contiguous(), t[1:].permute(1, 2, 0)[None].contiguous()


# ---------------------------------------------------------------- decode
def decode(outputs: Dict[str, torch.Tensor], params: dict, inds: Optional[torch.Tensor] = None):
    """The tracking model's decode of one image (rep_mode 1, Gaussian
    fitting), at its K best peaks, or at the cells `inds` [1, k] (flat
    output indices) when given: host arrays [1, k, n]."""
    heat = refdecode.sigmoid_clamped(outputs["hm"].to(torch.float32))
    k = int(params["K"]) if inds is None else int(inds.shape[1])
    real_topk = refdecode.topk
    if inds is not None:
        w = heat.shape[2]

        def forced(scores, kk):
            score = torch.gather(heat.reshape(1, -1), 1, inds)
            ys = torch.div(inds, w, rounding_mode="floor").to(torch.float32)
            xs = (inds % w).to(torch.float32)
            return score, inds, torch.zeros_like(inds, dtype=torch.int32), ys, xs
        refdecode.topk = forced
    try:
        dets = refdecode.object_pose_decode(outputs, k=k, rep_mode=1, inference=True, fit_gaussian=True,
                                            apply_sigmoid=True,
                                            balance_coefficient=float(params["balance_coefficient"]),
                                            hm_hp_thresh=float(params["hm_hp_thresh"]))
        if inds is None:
            inds = real_topk(refdecode.heat_nms(heat), k)[1]
    finally:
        refdecode.topk = real_topk
    at = {name: refdecode.gather_feat(outputs[name].to(torch.float32), inds)
          for name in ("hps_uncertainty", "scale_uncertainty", "tracking", "tracking_hp")}
    dets["kps_displacement_std"] = torch.sqrt(torch.exp(at["hps_uncertainty"])) * float(params["balance_coefficient"])
    dets["obj_scale_uncertainty"] = torch.sqrt(torch.exp(at["scale_uncertainty"]))
    dets["tracking"], dets["tracking_hp"] = at["tracking"], at["tracking_hp"]
    return {name: v.cpu().numpy().astype(np.float64) for name, v in dets.items()}


def post_merge(dets: Dict[str, np.ndarray], frame_hw, out_res: int, params: dict) -> List[dict]:
    """The detections above `vis_thresh` in image pixels, after soft-NMS
    (the port's `Detector.post_process` and `merge_outputs`)."""
    scores = dets["scores"][0, :, 0]
    idx = np.nonzero(scores > params["vis_thresh"])[0]
    if idx.size == 0:
        return []
    t = refserve.crop_transform(frame_hw[0], frame_hw[1], out_res, inverse=True)
    factor = max(frame_hw) / out_res

    def image(name):
        return refserve._to_image(dets[name][0, idx], t)

    bboxes, kps, disp, heat = image("bboxes"), image("kps"), image("kps_displacement_mean"), image("kps_heatmap_mean")
    found = []
    for m, i in enumerate(idx):
        b = bboxes[m]
        found.append({
            "score": float(scores[i]), "cls": int(dets["clses"][0, i, 0]), "bbox": b,
            "ct": np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2]), "kps": kps[m],
            "kps_displacement_mean": disp[m], "kps_heatmap_mean": heat[m],
            "kps_displacement_std": dets["kps_displacement_std"][0, i] * factor * STD_COEFFICIENT,
            "kps_heatmap_std": dets["kps_heatmap_std"][0, i] * factor * STD_COEFFICIENT,
            "tracking": dets["tracking"][0, i] * factor, "tracking_hp": dets["tracking_hp"][0, i] * factor,
            "obj_scale": dets["obj_scale"][0, i], "obj_scale_uncertainty": dets["obj_scale_uncertainty"][0, i],
        })
    keep = refserve.soft_nms(np.stack([d["bbox"] for d in found]), np.array([d["score"] for d in found]),
                             threshold=params["vis_thresh"])
    return [found[m] for m in keep]


def fuse(det: dict) -> None:
    """Inverse-variance fusion of the displacement and heatmap keypoints;
    the displacement estimate alone where the heatmap has none."""
    hm_mean, hm_std = det["kps_heatmap_mean"], det["kps_heatmap_std"]
    d_mean, d_std = det["kps_displacement_mean"], det["kps_displacement_std"]
    bad = (hm_mean < 0) | (hm_std < 0)
    var_d, var_h = np.maximum(d_std, 1e-9) ** -2.0, np.maximum(hm_std, 1e-9) ** -2.0
    std = (var_d + var_h) ** -0.5
    det["kps_fusion_mean"] = np.where(bad, d_mean, std ** 2 * (var_d * d_mean + var_h * hm_mean))
    det["kps_fusion_std"] = np.where(bad, d_std, std)


def solve(points: np.ndarray, scales: Sequence[np.ndarray], frame_hw, device) -> List[Optional[np.ndarray]]:
    """PnP of each row of `points` [M, N, 2] against the cuboid of its scale
    over its height: pnp_shell's [9, 2] projection over width and height,
    or None where the solve or the visibility test fails."""
    if not len(points):
        return []
    cubs = np.stack([refserve.cuboid(np.asarray(s, np.float64)) for s in scales])
    res = solve_pnp_batch(points.astype(np.float32), cubs.astype(np.float32), refserve.DEFAULT_CAMERA, device=device)
    valid, proj = res.valid.cpu().numpy(), res.projected.cpu().numpy().astype(np.float64)
    out = []
    for m in range(len(points)):
        p9 = np.vstack([proj[m].mean(axis=0, keepdims=True), proj[m]]) / [frame_hw[1], frame_hw[0]]
        ok = bool(valid[m]) and 0 < p9[0, 0] < 1 and 0 < p9[0, 1] < 1
        out.append(p9 if ok else None)
    return out


# ---------------------------------------------------------------- tracker
def track(state: State, dets: List[dict], frame_hw, params: dict, device) -> Tuple[State, List[dict]]:
    """The tracker's step from `state` (left unchanged) with the frame's
    detections: (the new state, the final boxes)."""
    tracks = copy.deepcopy(state.tracks)
    id_count = state.id_count
    n, m = len(dets), len(tracks)
    dc = np.array([np.asarray(d["ct"]) + np.asarray(d["tracking"]) for d in dets], np.float32).reshape(n, 2)
    tc = np.array([t["ct"] for t in tracks], np.float32).reshape(m, 2)

    def area(b):
        return (b[2] - b[0]) * (b[3] - b[1])

    t_size = np.array([area(t["bbox"]) for t in tracks], np.float32)
    d_size = np.array([area(d["bbox"]) for d in dets], np.float32)
    dist = ((tc[None] - dc[:, None]) ** 2).sum(axis=2)
    gated = (dist > t_size[None]) | (dist > d_size[:, None]) | (
        np.array([d["cls"] for d in dets])[:, None] != np.array([t["cls"] for t in tracks])[None])
    dist = dist + gated * 1e18
    matches = []
    if m:
        work = dist.copy()
        for i in range(n):
            j = int(work[i].argmin())
            if work[i, j] < 1e16:
                work[:, j] = 1e18
                matches.append((i, j))
    matched_d = {i for i, _ in matches}
    matched_t = {j for _, j in matches}
    out = []
    for i, j in matches:
        d, prev = dets[i], tracks[j]
        d.update(tracking_id=prev["tracking_id"], age=1, active=prev.get("active", 0) + 1)
        if "kf" in prev:
            d["kf"] = kf_step(prev["kf"], d["kps_fusion_mean"], d["kps_fusion_std"], d["tracking_hp"],
                              params["kf_r_velocity"])
        d["scale_pool"] = prev["scale_pool"] + [(d["obj_scale"], d["obj_scale_uncertainty"])]
        out.append(d)
    for i in range(n):
        d = dets[i]
        if i in matched_d or d["score"] <= params["new_thresh"]:
            continue
        id_count += 1
        d.update(tracking_id=id_count, age=1, active=1,
                 kf=kf_init(d["kps_fusion_mean"], d["kps_fusion_std"], d["tracking_hp"], params["kf_r_velocity"]),
                 scale_pool=[(d["obj_scale"], d["obj_scale_uncertainty"])])
        out.append(d)
    for j in range(m):
        t = tracks[j]
        if j not in matched_t and t["age"] < params["max_age"]:
            t["age"] += 1
            t["active"] = 0
            out.append(t)

    rows, scales, confs = [], [], []
    for t in out:
        kps = np.asarray(t["kps"], np.float64).reshape(-1, 2)
        conf = None
        if "kf" in t:
            kps = t["kf"][0][:, :2].copy()
            conf = kf_confidence(t["kf"], params["conf_border"])
            t["kps_std_kf"] = np.sqrt(np.stack([t["kf"][1][:, 0, 0], t["kf"][1][:, 1, 1]], axis=1)).reshape(-1)
            kps[conf < 0.15] = INVALID
            t["kps_mean_kf"] = kps
        mean, _ = pool_scale(t["scale_pool"])
        t["obj_scale_kf"] = mean
        t["valid_points"] = int((kps[:, 0] > -5000).sum())
        rows.append(kps)
        scales.append(mean)
        confs.append(conf)
    boxes = []
    solved = solve(np.stack(rows)[: params["max_tracks"]], scales[: params["max_tracks"]], frame_hw, device) \
        if rows else []
    for t, conf, p9 in zip(out, confs, solved):
        if p9 is None:                   # a track without a pose keeps its last one
            continue
        t["kps_pnp_kf"] = p9
        if (float(np.sum(conf) / 8) if conf is not None else 1.0) > 0.25:
            boxes.append(t)
    return State(tracks=out, id_count=id_count), boxes


# ---------------------------------------------------------------- a frame
def cell_of(ct: np.ndarray, reg: np.ndarray, frame_hw, out_res: int, radius: int = 2) -> Tuple[int, int]:
    """The output cell a box of centre `ct` (image pixels) came from: the
    cell within `radius` whose centre (cell + `reg` [oh, ow, 2]) lies
    nearest (serving's `reference/serve.py::forced`)."""
    fwd = refserve.crop_transform(frame_hw[0], frame_hw[1], out_res, inverse=False)
    cx, cy = fwd[:, :2] @ np.asarray(ct, np.float64) + fwd[:, 2]
    best = None
    for y in range(max(int(cy) - radius, 0), min(int(cy) + radius + 1, out_res)):
        for x in range(max(int(cx) - radius, 0), min(int(cx) + radius + 1, out_res)):
            d = math.hypot(x + reg[y, x, 0] - cx, y + reg[y, x, 1] - cy)
            if best is None or d < best[0]:
                best = (d, y, x)
    return best[1], best[2]


@torch.no_grad()
def step(net, state: State, pre_frame: np.ndarray, frame: np.ndarray, cells: Optional[Sequence[np.ndarray]],
         params: dict, device) -> Frame:
    """One frame (uint8 [H, W, 3]) from `state`, `pre_frame` the frame
    before it. `cells`: the image-pixel centres of the program's
    detections, read at their cells (None: the reference's own K best
    peaks)."""
    size = int(params["input"])
    out_res = size // int(params["down_ratio"])
    frame_hw = frame.shape[:2]
    pre_hm, pre_hm_hp = render(state.tracks, frame_hw, size, params, device)
    x, pre_img = (refserve.warp(torch.from_numpy(np.ascontiguousarray(f[None])).to(device), size)
                  for f in (frame, pre_frame))
    outputs = net(x, pre_img, pre_hm, pre_hm_hp)
    own = post_merge(decode(outputs, params), frame_hw, out_res, params)
    choice = []
    if cells is None:
        found = own
    else:
        heat = refdecode.sigmoid_clamped(outputs["hm"][0, ..., 0].to(torch.float32)).cpu().numpy()
        reg = outputs["reg"][0].cpu().numpy().astype(np.float64)
        kth = float(np.sort(refdecode.heat_nms(torch.from_numpy(heat)[None, ..., None]).reshape(-1).numpy())
                    [-int(params["K"])])
        picked = [cell_of(c, reg, frame_hw, out_res) for c in cells]
        for y, x_ in picked:
            s = heat[y, x_]
            peak = heat[max(y - 1, 0):y + 2, max(x_ - 1, 0):x_ + 2].max()
            choice.append(max(0.0, peak - s, kth - s, params["vis_thresh"] - s))
        inds = torch.tensor([[y * out_res + x_ for y, x_ in picked]], dtype=torch.int64, device=device)
        found = post_merge(decode(outputs, params, inds), frame_hw, out_res, params) if picked else []
    for d in found:
        fuse(d)
    dets = _posed(found, frame_hw, device)
    new_state, boxes = track(state, dets, frame_hw, params, device)
    return Frame(state=new_state, boxes=boxes, own_dets=len(_posed(own, frame_hw, device)), choice_gaps=choice)


def _posed(found: List[dict], frame_hw, device) -> List[dict]:
    """The detections the tracker takes: those whose PnP of the 16
    rep_mode-1 points (displacement and heatmap keypoints interleaved)
    passed, or all of them where none did (tracker.py:115-123)."""
    if not found:
        return []
    points = np.stack([np.stack([d["kps_displacement_mean"].reshape(-1, 2), d["kps_heatmap_mean"].reshape(-1, 2)],
                                axis=1).reshape(-1, 2) for d in found])
    posed = solve(points, [d["obj_scale"] for d in found], frame_hw, device)
    return [d for d, p in zip(found, posed) if p is not None] or found
