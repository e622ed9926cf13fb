"""The plain training step the port's `make_train_step` is held against,
and the training batches both sides are given.

- Targets: a frozen copy of `centerpose_tpu_torch/data/targets.py::
  render_targets` for the image model with no symmetry copies, and of its
  `geometry/gaussian.py::{gaussian_radius, draw_gaussian}` (taken when the
  benchmark was defined), all NumPy.
- `make_batches`: 1 to 3 objects an image at random places, sizes and
  keypoints, from the seed; images smooth and random, normalised like the
  loader's; every row of every batch different.
- `centerpose_loss`: the image model's loss written again (focal loss on the
  two heatmaps, L1 on the keypoint displacements, box sizes, scales and both
  offsets, weights 1, 0.1 for the boxes), the mean over the batch, and each
  term's.
- `steps`: the reference's first steps (train-mode BatchNorm, loss, backward,
  clip of the global norm to `max_norm` by `max_norm / max(norm, max_norm)`,
  Adam b1 0.9, b2 0.999, eps 1e-8), returning each step's loss, the first
  step's loss terms and clipped gradient, and the parameters after the last.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from posebench import inputs

NUM_JOINTS = 8
MAX_OBJS = 10
DATA_MEAN = (0.408, 0.447, 0.470)
DATA_STD = (0.289, 0.274, 0.278)


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap: np.ndarray, center, radius: int) -> None:
    diameter = 2 * radius + 1
    sigma = diameter / 6.0
    m = (diameter - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if left + right <= 0 or top + bottom <= 0:
        return
    window = heatmap[y - top:y + bottom, x - left:x + right]
    np.maximum(window, g[radius - top:radius + bottom, radius - left:radius + right], out=window)


def render_targets(objects, out_hw) -> Dict[str, np.ndarray]:
    """Targets of one image (symmetry axis of 1), `objects` a list of
    (center [2], size [2], keypoints [8, 2], scale [3]) in output pixels."""
    h, w = out_hw
    j, m = NUM_JOINTS, MAX_OBJS
    t = {"hm": np.zeros((1, h, w, 1), np.float32), "hm_hp": np.zeros((1, h, w, j), np.float32),
         "ind": np.zeros((1, m), np.int64), "reg": np.zeros((1, m, 2), np.float32),
         "reg_mask": np.zeros((1, m), np.float32), "wh": np.zeros((1, m, 2), np.float32),
         "scale": np.zeros((1, m, 3), np.float32), "hps": np.zeros((1, m, 2 * j), np.float32),
         "hps_mask": np.zeros((1, m, 2 * j), np.float32), "hp_ind": np.zeros((1, j * m), np.int64),
         "hp_offset": np.zeros((1, j * m, 2), np.float32), "hp_mask": np.zeros((1, j * m), np.float32)}
    for k, (ct, size, kps, scale) in enumerate(objects[:m]):
        ct = np.asarray(ct, np.float32)
        ct_int = ct.astype(np.int32)
        if not (0 <= ct_int[0] < w and 0 <= ct_int[1] < h):
            continue
        radius = max(0, int(gaussian_radius((np.ceil(size[1]), np.ceil(size[0])))))
        draw_gaussian(t["hm"][0, :, :, 0], ct_int, radius)
        t["ind"][0, k] = ct_int[1] * w + ct_int[0]
        t["reg"][0, k] = ct - ct_int
        t["reg_mask"][0, k] = 1.0
        t["wh"][0, k] = size
        t["scale"][0, k] = scale
        for jj in range(j):
            pt = np.asarray(kps[jj], np.float32)
            pt_int = pt.astype(np.int32)
            if not (0 <= pt_int[0] < w and 0 <= pt_int[1] < h):
                continue
            t["hps"][0, k, 2 * jj:2 * jj + 2] = pt - ct_int
            t["hps_mask"][0, k, 2 * jj:2 * jj + 2] = 1.0
            draw_gaussian(t["hm_hp"][0, :, :, jj], pt_int, radius)
            t["hp_ind"][0, k * j + jj] = pt_int[1] * w + pt_int[0]
            t["hp_offset"][0, k * j + jj] = pt - pt_int
            t["hp_mask"][0, k * j + jj] = 1.0
    return t


def make_batches(seed: int, n_batches: int, batch_size: int, input_hw, down_ratio: int, low_hw,
                 device) -> List[Dict[str, torch.Tensor]]:
    """`n_batches` training batches on `device`: float32 NHWC images and the
    targets of 1-3 objects an image."""
    rng = np.random.default_rng([seed, 2])
    oh, ow = input_hw[0] // down_ratio, input_hw[1] // down_ratio
    n = n_batches * batch_size
    frames = inputs.smooth_frames(seed, n, input_hw, low_hw, device)
    targets = []
    for _ in range(n):
        objs = []
        for _ in range(int(rng.integers(1, 4))):
            size = rng.uniform(0.1, 0.35, 2) * [ow, oh]
            ct = rng.uniform(size / 2, [ow, oh] - size / 2)
            kps = ct + rng.uniform(-0.5, 0.5, (NUM_JOINTS, 2)) * size
            objs.append((ct, size, kps, rng.uniform(0.5, 1.5, 3) / 1.0))
        targets.append(render_targets(objs, (oh, ow)))
    mean = torch.tensor(DATA_MEAN, device=device)
    std = torch.tensor(DATA_STD, device=device)
    batches = []
    for b in range(n_batches):
        rows = slice(b * batch_size, (b + 1) * batch_size)
        batch = {k: torch.from_numpy(np.stack([t[k] for t in targets[rows]])).to(device) for k in targets[0]}
        img = torch.from_numpy(frames[rows]).to(device).to(torch.float32)
        batch["input"] = ((img / 255.0 - mean) / std).contiguous()
        batches.append(batch)
    return batches


def _gather(feat, ind):
    b, h, w, d = feat.shape
    return torch.gather(feat.reshape(b, h * w, d), 1, ind[:, 0, :, None].expand(-1, -1, d))


def _focal(logits, gt):
    pred = torch.sigmoid(logits).clamp(1e-4, 1 - 1e-4)
    gt = gt[:, 0]
    pos = (gt == 1.0).float()
    neg = 1.0 - pos
    pos_loss = (torch.log(pred) * (1 - pred) ** 2 * pos).sum(dim=(1, 2, 3))
    neg_loss = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4 * neg).sum(dim=(1, 2, 3))
    num_pos = pos.sum(dim=(1, 2, 3))
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


def _l1(feat, mask, ind, target):
    """|target - prediction| summed over the masked entries of each row, over
    the mask's sum: a mask of one per object ([B, 1, M], the sum counts
    objects) or one per coordinate ([B, 1, M, D], the sum counts
    coordinates)."""
    pred = _gather(feat, ind)
    m = mask[:, 0]
    m = m[..., None] if m.dim() == 2 else m
    return (torch.abs(target[:, 0] - pred) * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) + 1e-4)


def centerpose_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the weighted loss, each term's mean over the batch by the port's
    names)."""
    out = {k: v.float() for k, v in out.items()}
    terms = {"hm_loss": (1.0, _focal(out["hm"], batch["hm"])),
             "hp_loss": (1.0, _l1(out["hps"], batch["hps_mask"], batch["ind"], batch["hps"])),
             "wh_loss": (0.1, _l1(out["wh"], batch["reg_mask"], batch["ind"], batch["wh"])),
             "obj_scale_loss": (1.0, _l1(out["scale"], batch["reg_mask"], batch["ind"], batch["scale"])),
             "off_loss": (1.0, _l1(out["reg"], batch["reg_mask"], batch["ind"], batch["reg"])),
             "hp_offset_loss": (1.0, _l1(out["hp_offset"], batch["hp_mask"], batch["hp_ind"], batch["hp_offset"])),
             "hm_hp_loss": (1.0, _focal(out["hm_hp"], batch["hm_hp"]))}
    loss = sum(w * v for w, v in terms.values()).mean()
    return loss, {k: v.mean() for k, (_, v) in terms.items()}


def steps(net, batches, lr: float, max_norm: float, autocast_bf16: bool = False
          ) -> Tuple[List[float], Dict[str, float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The reference's steps over `batches`: (losses, the first step's loss
    terms, the first step's clipped gradient by parameter name, the
    parameters after the last)."""
    params = dict(net.named_parameters())
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, foreach=False)
    net.train()
    losses, terms1, first = [], None, None
    for batch in batches:
        for p in params.values():
            p.grad = None
        ctx = (torch.autocast("cuda" if batch["input"].is_cuda else "cpu", dtype=torch.bfloat16)
               if autocast_bf16 else contextlib.nullcontext())
        with ctx:
            out = net(batch["input"])
        loss, terms = centerpose_loss(out, batch)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in params.values()))
        scale = float(max_norm / max(float(norm), max_norm))
        for p in params.values():
            p.grad.mul_(scale)
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
            terms1 = {k: float(v.detach()) for k, v in terms.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, terms1, first, {k: p.detach().clone() for k, p in params.items()}
