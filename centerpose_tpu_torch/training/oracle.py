"""Oracle / ground-truth substitution hooks for bug isolation, counterpart of
`centerpose_tpu/training/oracle.py`.

Parity targets: `gen_oracle_map` (src/lib/utils/oracle_utils.py:9-43, a
numba BFS fill) and the `--eval_oracle_*` substitution points
(trains/object_pose.py:67-83): selected predictions are replaced by ground
truth inside the loss or the decode, to tell decode / PnP faults from the
network's accuracy.

`gen_oracle_map` seeds the map with each object's vector at its `ind`
pixel and fills every other pixel with the vector of its nearest seed (in
L2, through scipy's KD-tree, as the JAX package does in place of the BFS).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def gen_oracle_map(values: np.ndarray, inds: np.ndarray, h: int, w: int) -> np.ndarray:
    """values [B, M, D], inds [B, M] flattened positions (0 = no object) →
    dense [B, H, W, D] float32 map where every pixel holds its nearest seeded
    object's vector (zeros for an image without objects)."""
    from scipy.spatial import cKDTree

    values, inds = np.asarray(values), np.asarray(inds)
    b, _, d = values.shape
    out = np.zeros((b, h, w, d), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    grid = np.stack([ys.ravel(), xs.ravel()], axis=1)
    for bi in range(b):
        valid = inds[bi] > 0
        if not valid.any():
            continue
        seeds = np.stack([inds[bi][valid] // w, inds[bi][valid] % w], axis=1)
        _, nearest = cKDTree(seeds).query(grid)
        out[bi] = values[bi][valid][nearest].reshape(h, w, d)
    return out


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p))


def _oracle_map(pred: torch.Tensor, values, inds, symmetry_id: int) -> torch.Tensor:
    h, w = pred.shape[1:3]
    dense = gen_oracle_map(torch.as_tensor(values[:, symmetry_id]).cpu().numpy(),
                           torch.as_tensor(inds[:, symmetry_id]).cpu().numpy(), h, w)
    return torch.from_numpy(dense).to(pred.device)


def apply_oracles(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  oracles: Dict[str, bool], symmetry_id: int = 0) -> Dict[str, torch.Tensor]:
    """Replace selected NHWC head outputs by ground truth (trains/
    object_pose.py:67-83). `oracles` keys: hm, hm_hp, kps, hp_offset; True
    replaces that prediction. Ground-truth heatmaps ([B, S, H, W, C] in the
    batch, symmetry `symmetry_id`) are logit-inverted so that the loss's or
    the decode's sigmoid gives them back; keypoint and offset maps are the
    nearest-object fill of `gen_oracle_map`, on the outputs' device."""
    out = dict(outputs)
    if oracles.get("hm"):
        out["hm"] = _logit(batch["hm"][:, symmetry_id])
    if oracles.get("hm_hp") and "hm_hp" in batch:
        out["hm_hp"] = _logit(batch["hm_hp"][:, symmetry_id])
    if oracles.get("kps"):
        out["hps"] = _oracle_map(outputs["hps"], batch["hps"], batch["ind"], symmetry_id)
    if oracles.get("hp_offset") and "hp_offset" in batch:
        out["hp_offset"] = _oracle_map(outputs["hp_offset"], batch["hp_offset"], batch["hp_ind"],
                                       symmetry_id)
    return out
