"""Synthetic DOPE-format scene generator with exact ground truth.

Closes the accuracy loop (train → checkpoint → detector → Objectron-style AP)
without the real Objectron dataset: cuboid objects resting on a ground plane are
rendered through known intrinsics, and the emitted png+json pairs carry the full
DOPE schema the training dataset (data/dataset.py) and the metric evaluator
(evaluation/evaluator.py `parse_gt_json`) consume — the same schema the
reference's own offline preprocessor writes (reference data/utils.py:95-290).

Conventions (must match the inference stack end to end):
  * OpenCV camera frame (x right, y down, z forward) for projection:
    u = fx·X/Z + cx (ops/pnp.py `_project`);
  * stored `location`/`quaternion_xyzw`/`keypoints_3d` are in the OpenGL frame
    obtained by the solver's x↔y swap + z negation (ops/pnp.py `_GL_SWAP`,
    reference cuboid_pnp_solver.py:179-196);
  * cuboid corners in binary-counting order over (x, y, z) sign bits with the
    9-point annotation prepending the center (geometry/cuboid.py);
  * `AR_data.plane_{center,normal}` give the ground plane in the GL camera
    frame — the evaluator's metric-scale recovery (`compute_plane_scale`,
    reference eval_image_official.py:795-803) rescales the height-normalized
    PnP box so its bottom face sits on this plane, which is exact here because
    every generated object rests on the plane.

Rendering is dependency-light (PIL polygons + numpy): each cuboid face has a
fixed distinct hue keyed to its object-frame normal, Lambert-shaded by a random
light — pose and corner identity are fully observable from appearance, so a
detector trained on these images can in principle reach AP = 1.

The PyTorch package's own copy of `centerpose_tpu/data/synthetic.py`: the
same scenes, frames and annotations from the same seed, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices

# GL ↔ CV conversion (an involution): x↔y swap, z negated.
GL_SWAP = np.array(
    [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], np.float64
)

# Cuboid faces in the binary corner order (x = bit 4, y = bit 2, z = bit 1):
# (object-frame outward normal, corner cycle around the face).
_FACES: Tuple[Tuple[Tuple[float, float, float], Tuple[int, int, int, int]], ...] = (
    ((-1.0, 0.0, 0.0), (0, 1, 3, 2)),
    ((+1.0, 0.0, 0.0), (4, 5, 7, 6)),
    ((0.0, -1.0, 0.0), (0, 1, 5, 4)),
    ((0.0, +1.0, 0.0), (2, 3, 7, 6)),
    ((0.0, 0.0, -1.0), (0, 2, 6, 4)),
    ((0.0, 0.0, +1.0), (1, 3, 7, 5)),
)

# Fixed distinct base color per face normal (indexed like _FACES): corner
# identity (front/rear/left/right) is visually unambiguous.
_FACE_COLORS = np.array(
    [
        [0.25, 0.45, 0.95],  # -x  blue
        [0.95, 0.30, 0.25],  # +x  red
        [0.50, 0.35, 0.20],  # -y  brown (bottom, rarely visible)
        [0.95, 0.85, 0.25],  # +y  yellow (top)
        [0.75, 0.30, 0.90],  # -z  purple (rear)
        [0.25, 0.85, 0.45],  # +z  green (front)
    ],
    np.float64,
)


@dataclasses.dataclass
class SceneObject:
    scale: np.ndarray    # [3] metric (w, h, d) full extents
    yaw: float           # rotation about the world up axis
    pos_xz: np.ndarray   # [2] ground position; the object rests on y=0
    tint: np.ndarray     # [3] per-object color modulation

    def rotation_world(self) -> np.ndarray:
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    def center_world(self) -> np.ndarray:
        return np.array(
            [self.pos_xz[0], self.scale[1] / 2.0, self.pos_xz[1]]
        )


@dataclasses.dataclass
class Camera:
    eye: np.ndarray      # [3] world position
    target: np.ndarray   # [3] world look-at point
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )

    def extrinsics_cv(self) -> Tuple[np.ndarray, np.ndarray]:
        """World → OpenCV-camera (x right, y down, z forward): R_w2c, t_w2c."""
        up = np.array([0.0, 1.0, 0.0])
        z = self.target - self.eye
        z = z / np.linalg.norm(z)
        x = np.cross(-up, z)
        nx = np.linalg.norm(x)
        if nx < 1e-9:  # looking straight down — pick any horizontal x
            x = np.array([1.0, 0.0, 0.0])
        else:
            x = x / nx
        y = np.cross(z, x)
        r = np.stack([x, y, z])  # rows = camera axes in world coords
        return r, -r @ self.eye

    def gl_projection_matrix(self) -> np.ndarray:
        """4×4 matrix mapping GL-camera-frame points to clip space under the
        reference's viewport convention (dataset_combined.py:1004-1009:
        vx = (ndc[1]+1)/2·width, vy = (ndc[0]+1)/2·height — note the axis
        swap), with w_clip = −z_gl."""
        w, h = float(self.width), float(self.height)
        zn, zf = 0.05, 100.0
        p = np.zeros((4, 4))
        p[1, 1] = 2.0 * self.fx / w
        p[1, 2] = (w - 2.0 * self.cx) / w
        p[0, 0] = 2.0 * self.fy / h
        p[0, 2] = (h - 2.0 * self.cy) / h
        p[2, 2] = (zf + zn) / (zn - zf)
        p[2, 3] = 2.0 * zf * zn / (zn - zf)
        p[3, 2] = -1.0
        return p


def project_cv(points_cv: np.ndarray, cam: Camera) -> np.ndarray:
    """Pinhole projection of OpenCV-camera-frame points → pixels [N, 2]."""
    z = np.maximum(points_cv[:, 2], 1e-9)
    u = cam.fx * points_cv[:, 0] / z + cam.cx
    v = cam.fy * points_cv[:, 1] / z + cam.cy
    return np.stack([u, v], axis=-1)


def object_pose_cv(obj: SceneObject, cam: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """Object→OpenCV-camera pose (R, t)."""
    r_w2c, t_w2c = cam.extrinsics_cv()
    r = r_w2c @ obj.rotation_world()
    t = r_w2c @ obj.center_world() + t_w2c
    return r, t


def object_annotation(obj: SceneObject, cam: Camera, name: str) -> dict:
    """One DOPE `objects[]` entry with exact GT in the GL convention."""
    from scipy.spatial.transform import Rotation as R

    r_cv, t_cv = object_pose_cv(obj, cam)
    corners_obj = cuboid_vertices(obj.scale)          # metric, binary order
    corners_cv = corners_obj @ r_cv.T + t_cv
    proj9 = project_cv(np.vstack([t_cv[None], corners_cv]), cam)

    r_gl = GL_SWAP @ r_cv
    t_gl = GL_SWAP @ t_cv
    kps3d_gl = np.vstack([t_gl[None], corners_cv @ GL_SWAP.T])
    return {
        "name": name,
        "class": "synthetic",
        "location": t_gl.tolist(),
        "quaternion_xyzw": R.from_matrix(r_gl).as_quat().tolist(),
        "scale": np.asarray(obj.scale, np.float64).tolist(),
        "keypoints_3d": kps3d_gl.tolist(),
        "projected_cuboid": proj9.tolist(),
    }


def frame_annotation(objects: Sequence[SceneObject], cam: Camera) -> dict:
    """Full DOPE json dict for one frame (camera_data + AR_data + objects)."""
    r_w2c, t_w2c = cam.extrinsics_cv()
    plane_normal_gl = GL_SWAP @ (r_w2c @ np.array([0.0, 1.0, 0.0]))
    plane_center_gl = GL_SWAP @ t_w2c  # world origin lies on the plane
    return {
        "camera_data": {
            "width": cam.width,
            "height": cam.height,
            "intrinsics": {
                "fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
            },
            "camera_projection_matrix": cam.gl_projection_matrix().tolist(),
        },
        "AR_data": {
            "plane_center": plane_center_gl.tolist(),
            "plane_normal": plane_normal_gl.tolist(),
        },
        "objects": [
            object_annotation(o, cam, f"obj_{i}")
            for i, o in enumerate(objects)
        ],
    }


# --------------------------------------------------------------------- render
def render_frame(
    objects: Sequence[SceneObject], cam: Camera, rng: np.random.RandomState
) -> np.ndarray:
    """Rasterize the scene: clutter background + Lambert-shaded cuboids."""
    from PIL import Image, ImageDraw, ImageFilter

    w, h = cam.width, cam.height
    # Background: vertical gradient between two random colors + soft blobs.
    c0 = rng.uniform(40, 215, 3)
    c1 = rng.uniform(40, 215, 3)
    ramp = np.linspace(0.0, 1.0, h)[:, None, None]
    bg = (c0 * (1 - ramp) + c1 * ramp) * np.ones((h, w, 3))
    img = Image.fromarray(bg.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for _ in range(rng.randint(3, 8)):
        ex, ey = rng.randint(0, w), rng.randint(0, h)
        er = rng.randint(w // 16, w // 4)
        col = tuple(int(v) for v in rng.uniform(30, 225, 3))
        draw.ellipse([ex - er, ey - er, ex + er, ey + er], fill=col)
    img = img.filter(ImageFilter.GaussianBlur(radius=6))
    draw = ImageDraw.Draw(img)

    light = rng.normal(size=3)
    light[2] = -abs(light[2]) - 0.5  # biased toward the camera
    light = light / np.linalg.norm(light)

    # Painter's order across objects (far → near); backface culling makes each
    # convex box self-consistent.
    order = np.argsort(
        [-object_pose_cv(o, cam)[1][2] for o in objects]
    )
    for oi in order:
        obj = objects[oi]
        r_cv, t_cv = object_pose_cv(obj, cam)
        corners_cv = cuboid_vertices(obj.scale) @ r_cv.T + t_cv
        pix = project_cv(corners_cv, cam)
        for fi, (n_obj, cycle) in enumerate(_FACES):
            n_cv = r_cv @ np.asarray(n_obj)
            face_center = corners_cv[list(cycle)].mean(axis=0)
            if np.dot(n_cv, face_center) >= 0:  # facing away
                continue
            lam = max(0.0, float(np.dot(n_cv, -light)))
            shade = 0.40 + 0.60 * lam
            col = np.clip(_FACE_COLORS[fi] * obj.tint * shade, 0, 1) * 255
            poly = [tuple(pix[c]) for c in cycle]
            draw.polygon(poly, fill=tuple(int(v) for v in col))
            edge = tuple(int(v) for v in col * 0.45)
            draw.line(poly + [poly[0]], fill=edge, width=2)

    out = np.asarray(img, np.float32)
    out = out + rng.normal(0.0, 3.0, out.shape).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------- sampling
def _sample_objects(
    rng: np.random.RandomState, n_objects: int
) -> List[SceneObject]:
    objs: List[SceneObject] = []
    for _ in range(n_objects):
        for _attempt in range(50):
            height = rng.uniform(0.12, 0.30)
            scale = np.array(
                [height * rng.uniform(0.55, 1.6),
                 height,
                 height * rng.uniform(0.55, 1.6)]
            )
            pos = rng.uniform(-0.22, 0.22, 2)
            if all(
                np.linalg.norm(pos - o.pos_xz)
                > 0.6 * (max(scale[0], scale[2]) + max(o.scale[0], o.scale[2]))
                for o in objs
            ):
                break
        objs.append(
            SceneObject(
                scale=scale,
                yaw=rng.uniform(0, 2 * np.pi),
                pos_xz=pos,
                tint=rng.uniform(0.65, 1.25, 3),
            )
        )
    return objs


def _sample_camera(
    rng: np.random.RandomState, width: int, height: int,
    azimuth: Optional[float] = None,
) -> Camera:
    dist = rng.uniform(0.9, 1.5)
    elev = rng.uniform(np.deg2rad(18), np.deg2rad(55))
    az = rng.uniform(0, 2 * np.pi) if azimuth is None else azimuth
    eye = np.array(
        [dist * np.cos(elev) * np.cos(az),
         dist * np.sin(elev),
         dist * np.cos(elev) * np.sin(az)]
    )
    target = np.array([rng.uniform(-0.04, 0.04), 0.0, rng.uniform(-0.04, 0.04)])
    f = 0.95 * max(width, height) * rng.uniform(0.9, 1.1)
    return Camera(
        eye=eye, target=target, fx=f, fy=f,
        cx=width / 2.0 + rng.uniform(-4, 4),
        cy=height / 2.0 + rng.uniform(-4, 4),
        width=width, height=height,
    )


def _frame_valid(objects: Sequence[SceneObject], cam: Camera, margin: float) -> bool:
    """All 9 keypoints of every object inside the image, in front of camera."""
    for obj in objects:
        r_cv, t_cv = object_pose_cv(obj, cam)
        pts = np.vstack([t_cv[None], cuboid_vertices(obj.scale) @ r_cv.T + t_cv])
        if np.any(pts[:, 2] < 0.15):
            return False
        pix = project_cv(pts, cam)
        if (
            pix[:, 0].min() < margin or pix[:, 0].max() > cam.width - margin
            or pix[:, 1].min() < margin or pix[:, 1].max() > cam.height - margin
        ):
            return False
    return True


def make_scene(
    rng: np.random.RandomState,
    width: int = 480,
    height: int = 480,
    n_objects: Optional[int] = None,
    azimuth: Optional[float] = None,
    margin: float = 8.0,
) -> Tuple[List[SceneObject], Camera]:
    """Sample a valid (fully-visible) scene + camera; retries until valid."""
    n = int(rng.randint(1, 3)) if n_objects is None else n_objects
    for _ in range(200):
        objects = _sample_objects(rng, n)
        cam = _sample_camera(rng, width, height, azimuth=azimuth)
        if _frame_valid(objects, cam, margin):
            return objects, cam
    raise RuntimeError("could not sample a valid synthetic scene")


def generate_dataset(
    out_dir: str,
    n_videos: int = 10,
    frames_per_video: int = 10,
    seed: int = 0,
    width: int = 480,
    height: int = 480,
    video_motion: bool = False,
) -> List[str]:
    """Write `{out_dir}/video_{v}/{frame:06d}.{png,json}` pairs.

    video_motion=True keeps each video's objects fixed and orbits the camera
    smoothly (for tracking eval); otherwise every frame is an independent
    scene (image-model training diversity).
    """
    rng = np.random.RandomState(seed)
    paths = []
    for v in range(n_videos):
        vdir = os.path.join(out_dir, f"video_{v}")
        os.makedirs(vdir, exist_ok=True)
        if video_motion:
            base_az = rng.uniform(0, 2 * np.pi)
            objects = None
            for f in range(frames_per_video):
                az = base_az + f * np.deg2rad(3.0)
                for _ in range(200):
                    if objects is None:
                        objects, cam = make_scene(rng, width, height, azimuth=az)
                        break
                    cam = _sample_camera(rng, width, height, azimuth=az)
                    if _frame_valid(objects, cam, 8.0):
                        break
                else:
                    objects, cam = make_scene(rng, width, height, azimuth=az)
                paths.append(_write_frame(vdir, f, objects, cam, rng))
        else:
            for f in range(frames_per_video):
                objects, cam = make_scene(rng, width, height)
                paths.append(_write_frame(vdir, f, objects, cam, rng))
    return paths


def _write_frame(vdir: str, f: int, objects, cam, rng) -> str:
    from PIL import Image

    img = render_frame(objects, cam, rng)
    img_path = os.path.join(vdir, f"{f:06d}.png")
    Image.fromarray(img).save(img_path)
    with open(os.path.join(vdir, f"{f:06d}.json"), "w") as fh:
        json.dump(frame_annotation(objects, cam), fh)
    return img_path
