"""Named-canvas debug renderer — the reference `Debugger` re-done cv2-free.

Parity target: `src/lib/utils/debugger.py:11-485`. Same canvas protocol
(`add_img` / `add_blend_img` / `gen_colormap` / `gen_colormap_hp` /
`add_coco_bbox` / `add_coco_hp` / `add_obj_scale` / `add_arrow` / `add_axes` /
`save_all_imgs`) and the same named canvases the detector and trainer emit
(out_hm_pred, out_hmhp_pred, out_img_pred, out_img_gt, out_pred_gt_blend,
pre_hm, pre_hmhp, out_kps_processed_pred, out_tracking_pred, ...).

Colors are RGB (the reference is BGR under cv2); the per-joint palette, the
cuboid edge list, and the front/top face crosses match debugger.py:30-48.
Text is rendered with a built-in 3x5 bitmap font (no cv2/font dependency).
Pure numpy pixel drawing — debug path only, never hot.

The PyTorch package's own copy of `centerpose_tpu/utils/debugger.py`: the same
canvases, pixel for pixel, for the same inputs.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from centerpose_tpu_torch.utils.visualize import _draw_line, _draw_point

# Cuboid wireframe over the 8 corners, 1-indexed (debugger.py:30-33).
EDGES = [[2, 4], [2, 6], [6, 8], [4, 8],
         [1, 2], [3, 4], [5, 6], [7, 8],
         [1, 3], [1, 5], [3, 7], [5, 7]]
TOP_CROSS = [[3, 8], [4, 7]]     # debugger.py:34
FRONT_CROSS = [[2, 8], [4, 6]]   # debugger.py:35

# Per-joint palette (debugger.py:44-47, BGR→RGB).
COLORS_HP = [(255, 0, 0), (255, 165, 0), (255, 255, 0),
             (0, 128, 0), (0, 0, 255), (75, 0, 130), (238, 130, 238),
             (0, 0, 0)]

_EDGE_COLOR = {  # add_coco_hp edge colors by flag (debugger.py:231-239), BGR→RGB
    "pred": (255, 0, 0),
    "gt": (0, 255, 0),
    "pnp": (255, 0, 0),
    "extra": (255, 165, 0),
}
_CROSS_COLOR = {"pred": (255, 0, 0), "gt": (255, 255, 255), "pnp": (0, 0, 0),
                "extra": (255, 165, 0)}

# 3x5 bitmap glyphs for the text overlays (digits + the few letters used by
# add_obj_scale/add_coco_bbox labels).
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "/": "001001010100100",
    ":": "000010000010000", "-": "000000111000000",
    "P": "111101111100100", "r": "000000110100100", "e": "000011111110011",
    "d": "001001011101011", "G": "011100101101011", "T": "111010010010010",
    "n": "000000110101101", "p": "000110101110100", " ": "000000000000000",
}


def _draw_text(img, text: str, org, color=(255, 255, 255), scale: int = 2):
    """Minimal bitmap text (3x5 glyphs upscaled by `scale`)."""
    h, w = img.shape[:2]
    x0, y0 = int(org[0]), int(org[1])
    for ch in str(text):
        g = _GLYPHS.get(ch, _GLYPHS[" "])
        for i in range(5):
            for jj in range(3):
                if g[i * 3 + jj] == "1":
                    ya, yb = y0 + i * scale, y0 + (i + 1) * scale
                    xa, xb = x0 + jj * scale, x0 + (jj + 1) * scale
                    ya, yb = max(0, ya), min(h, yb)
                    xa, xb = max(0, xa), min(w, xb)
                    if ya < yb and xa < xb:
                        img[ya:yb, xa:xb] = color
        x0 += 4 * scale


class Debugger:
    """Collects named uint8 RGB canvases and draws detections onto them."""

    def __init__(self, theme: str = "black", num_joints: int = 8,
                 down_ratio: int = 4):
        self.imgs: Dict[str, np.ndarray] = {}
        self.theme = theme
        self.num_joints = num_joints
        self.down_ratio = down_ratio

    # ------------------------------------------------------------- canvases
    def add_img(self, img, img_id: str = "default", revert_color: bool = False):
        img = np.asarray(img)
        if revert_color:
            img = 255 - img
        self.imgs[img_id] = np.ascontiguousarray(img.astype(np.uint8).copy())

    def add_blend_img(self, back, fore, img_id: str = "blend", trans: float = 0.6):
        """debugger.py:63-73 — alpha blend, fore upsampled to back's size."""
        back = np.asarray(back, np.float64)
        fore = np.asarray(fore, np.float64)
        if self.theme == "white":
            fore = 255 - fore
        if fore.shape[:2] != back.shape[:2]:
            yy = (np.arange(back.shape[0]) * fore.shape[0] // back.shape[0]).clip(
                0, fore.shape[0] - 1)
            xx = (np.arange(back.shape[1]) * fore.shape[1] // back.shape[1]).clip(
                0, fore.shape[1] - 1)
            fore = fore[yy][:, xx]
        if fore.ndim == 2:
            fore = fore[..., None].repeat(3, axis=-1)
        out = back * (1.0 - trans) + fore * trans
        self.imgs[img_id] = out.clip(0, 255).astype(np.uint8)

    def gen_colormap(self, img, output_res=None, color=None) -> np.ndarray:
        """[H, W, C] (or [H, W]) heatmap → RGB colormap at output_res
        (debugger.py:75-98; the reference takes CHW — this codebase is NHWC)."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        img = np.moveaxis(img, -1, 0)
        c, h, w = img.shape
        if output_res is None:
            output_res = (h * self.down_ratio, w * self.down_ratio)
        colors = np.array(
            [color if color is not None else (255, 128, 64) for _ in range(c)],
            np.float32,
        )
        cmap = (img.clip(0, 1)[..., None] * colors[:, None, None, :]).max(axis=0)
        yy = (np.arange(output_res[0]) * h // output_res[0]).clip(0, h - 1)
        xx = (np.arange(output_res[1]) * w // output_res[1]).clip(0, w - 1)
        return cmap[yy][:, xx]

    def gen_colormap_hp(self, img, output_res=None) -> np.ndarray:
        """Per-joint colored [H, W, J] heatmap (debugger.py:116-129)."""
        img = np.asarray(img, np.float32)
        img = np.moveaxis(img, -1, 0)
        c, h, w = img.shape
        if output_res is None:
            output_res = (h * self.down_ratio, w * self.down_ratio)
        colors = np.array(COLORS_HP[:c], np.float32)
        cmap = (img.clip(0, 1)[..., None] * colors[:, None, None, :]).max(axis=0)
        yy = (np.arange(output_res[0]) * h // output_res[0]).clip(0, h - 1)
        xx = (np.arange(output_res[1]) * w // output_res[1]).clip(0, w - 1)
        return cmap[yy][:, xx]

    # ------------------------------------------------------------- drawing
    def add_coco_bbox(self, bbox, cat, conf=1.0, show_txt: bool = True,
                      img_id: str = "default"):
        img = self.imgs[img_id]
        b = np.asarray(bbox, np.float64).reshape(4)
        color = (127, 63, 63)
        _draw_line(img, b[[0, 1]], b[[2, 1]], color, 2)
        _draw_line(img, b[[2, 1]], b[[2, 3]], color, 2)
        _draw_line(img, b[[2, 3]], b[[0, 3]], color, 2)
        _draw_line(img, b[[0, 3]], b[[0, 1]], color, 2)
        if show_txt:
            _draw_text(img, f"{float(conf):.2f}", (b[0], b[1] - 12))

    def add_coco_hp(self, points, img_id: str = "default",
                    pred_flag: str = "pred"):
        """Cuboid wireframe + per-joint dots + visible-face crosses with the
        reference's -10000 sentinel skip (debugger.py:214-297)."""
        img = self.imgs[img_id]
        pts = np.asarray(points, np.float64).reshape(self.num_joints, 2)
        for j in range(self.num_joints):
            if pts[j, 0] <= -10000 or pts[j, 1] <= -10000:
                continue
            _draw_point(img, pts[j], COLORS_HP[j % len(COLORS_HP)], 4)
        ec = _EDGE_COLOR.get(pred_flag, (255, 0, 0))
        cc = _CROSS_COLOR.get(pred_flag, (255, 0, 0))
        for group, color in ((EDGES, ec), (FRONT_CROSS, cc), (TOP_CROSS, cc)):
            for e in group:
                a, b = e[0] - 1, e[1] - 1
                if (pts[a, 0] <= -10000 or pts[a, 1] <= -10000
                        or pts[b, 0] <= -10000 or pts[b, 1] <= -10000):
                    continue
                _draw_line(img, pts[a], pts[b], color, 2)

    def add_obj_scale(self, bbox, scale, img_id: str = "default",
                      pred_flag: str = "pred"):
        """Relative-dimension text block anchored to the bbox corner
        (debugger.py:165-193)."""
        img = self.imgs[img_id]
        b = np.asarray(bbox, np.float64).reshape(4)
        label = {"pred": "Pred", "gt": "GT", "pnp": "PnP"}.get(pred_flag, pred_flag)
        txt = f"{label}:{scale[0]:.3f}/{scale[1]:.3f}/{scale[2]:.3f}"
        y = b[1] + (14 if pred_flag == "pred" else 2)
        h, w = img.shape[:2]
        ya, yb = int(max(0, y)), int(min(h, y + 12))
        xa, xb = int(max(0, b[0])), int(min(w, b[0] + 4 * 2 * len(txt)))
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb] = (0, 0, 0)
        _draw_text(img, txt, (b[0], y + 1))

    def add_arrow(self, st, ed, img_id: str, c=(255, 0, 255), w: int = 2):
        """Track-offset arrow: from (st + ed) to st (debugger.py:324-333)."""
        img = self.imgs[img_id]
        p0 = np.array([st[0] + ed[0], st[1] + ed[1]], np.float64)
        p1 = np.asarray(st, np.float64)
        _draw_line(img, p0, p1, c, w)
        # arrow tip: two short back-strokes at ~30 deg.
        d = p1 - p0
        n = np.linalg.norm(d)
        if n > 1e-6:
            d = d / n
            tip = min(0.3 * n, 8.0)
            perp = np.array([-d[1], d[0]])
            _draw_line(img, p1, p1 - d * tip + perp * tip * 0.6, c, w)
            _draw_line(img, p1, p1 - d * tip - perp * tip * 0.6, c, w)

    def add_axes(self, box, cam_intrinsic, img_id: str = "default"):
        """Object axes from the 9-point 3D box (debugger.py:299-321): y (top)
        green, z (front) blue, x (right) red, each 0.5 long from the centroid."""
        img = self.imgs[img_id]
        box = np.asarray(box, np.float64)
        cam = np.asarray(cam_intrinsic, np.float64)
        vecs = [np.zeros(3), box[3] - box[1], box[2] - box[1], box[5] - box[1]]
        uv = []
        for v in vecs:
            n = np.linalg.norm(v)
            v = v / n * 0.5 if n > 0 else np.zeros(3)
            p = cam @ (v + box[0]).reshape(3)
            uv.append((float(p[0] / p[2]), float(p[1] / p[2])))
        for i, color in ((1, (0, 255, 0)), (2, (0, 0, 255)), (3, (255, 0, 0))):
            _draw_line(img, uv[0], uv[i], color, 4)

    # ------------------------------------------------------------- output
    def save_all_imgs(self, path: str, prefix: str = ""):
        """PNG dump of every canvas (debugger.py:356-359)."""
        from PIL import Image

        os.makedirs(path, exist_ok=True)
        for name, img in self.imgs.items():
            Image.fromarray(img).save(
                os.path.join(path, f"{prefix}{name}.png")
            )
