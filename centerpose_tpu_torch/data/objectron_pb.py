"""Objectron `Sequence` annotation (.pbdata) parser — dependency-free.

Parity target: the reference's protobuf-based offline preprocessing
(data/preprocess.py + data/utils.py export_to_ndds_file) reads
`Sequence{objects, frame_annotations}` through protoc-generated classes. This
module decodes the same wire format directly with the parser primitives from
centerpose_tpu_torch.data.tfrecord (the schema is Google's public Objectron
annotation schema; field numbers below are from its .proto definitions):

  Sequence:          1 objects (Object, repeated)     2 frame_annotations (rep.)
  Object:            1 id  2 category  4 rotation[9]  5 translation[3]  6 scale[3]
  FrameAnnotation:   1 frame_id  2 annotations  3 camera (ARCamera)
                     4 timestamp  5 plane_center[3]  6 plane_normal[3]
  ObjectAnnotation:  1 object_id  2 keypoints (AnnotatedKeyPoint)  3 visibility
  AnnotatedKeyPoint: 1 id  2 point_3d (x=1,y=2,z=3)  3 point_2d (x=1,y=2,depth=3)
  ARCamera:          3 transform[16]  5/6 image_resolution_w/h  7 intrinsics[9]
                     8 projection_matrix[16]  9 view_matrix[16]

The PyTorch package's copy of `centerpose_tpu/data/objectron_pb.py`.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from centerpose_tpu_torch.data.tfrecord import _iter_fields


def _floats(val: bytes, wtype: int) -> List[float]:
    if wtype == 2:  # packed
        return np.frombuffer(val, dtype="<f4").tolist()
    return [struct.unpack("<f", val)[0]]


def _parse_point(buf: bytes) -> List[float]:
    out = [0.0, 0.0, 0.0]
    for f, w, v in _iter_fields(buf):
        if 1 <= f <= 3 and w == 5:
            out[f - 1] = struct.unpack("<f", v)[0]
    return out


def _parse_keypoint(buf: bytes) -> Dict:
    kp = {"id": 0, "point_3d": [0.0] * 3, "point_2d": [0.0] * 3}
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 0:
            kp["id"] = v
        elif f == 2 and w == 2:
            kp["point_3d"] = _parse_point(v)
        elif f == 3 and w == 2:
            kp["point_2d"] = _parse_point(v)
    return kp


def _parse_object_annotation(buf: bytes) -> Dict:
    ann = {"object_id": 0, "keypoints": [], "visibility": 1.0}
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 0:
            ann["object_id"] = v
        elif f == 2 and w == 2:
            ann["keypoints"].append(_parse_keypoint(v))
        elif f == 3 and w == 5:
            ann["visibility"] = struct.unpack("<f", v)[0]
    return ann


def _parse_camera(buf: bytes) -> Dict:
    cam: Dict = {}
    names = {3: "transform", 7: "intrinsics", 8: "projection_matrix", 9: "view_matrix"}
    for f, w, v in _iter_fields(buf):
        if f in names:
            cam.setdefault(names[f], []).extend(_floats(v, w))
        elif f == 5 and w == 0:
            cam["image_resolution_width"] = v
        elif f == 6 and w == 0:
            cam["image_resolution_height"] = v
    for key, n in (("transform", 16), ("intrinsics", 9),
                   ("projection_matrix", 16), ("view_matrix", 16)):
        if key in cam:
            dim = int(np.sqrt(n))
            cam[key] = np.asarray(cam[key], np.float64).reshape(dim, dim)
    return cam


def _parse_frame_annotation(buf: bytes) -> Dict:
    fr = {"frame_id": 0, "annotations": [], "camera": {},
          "plane_center": None, "plane_normal": None}
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 0:
            fr["frame_id"] = v
        elif f == 2 and w == 2:
            fr["annotations"].append(_parse_object_annotation(v))
        elif f == 3 and w == 2:
            fr["camera"] = _parse_camera(v)
        elif f == 5:
            # extend, not assign: 'repeated float' may arrive as three
            # separate wire-type-5 fields instead of one packed blob (legal
            # proto encoding — same handling as _parse_camera/_parse_object).
            fr["plane_center"] = (fr["plane_center"] or []) + list(_floats(v, w))
        elif f == 6:
            fr["plane_normal"] = (fr["plane_normal"] or []) + list(_floats(v, w))
    return fr


def _parse_object(buf: bytes) -> Dict:
    obj = {"id": 0, "category": "", "rotation": None, "translation": None,
           "scale": None}
    acc = {4: [], 5: [], 6: []}
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 0:
            obj["id"] = v
        elif f == 2 and w == 2:
            obj["category"] = v.decode("utf-8", "replace")
        elif f in acc:
            acc[f].extend(_floats(v, w))
    if acc[4]:
        obj["rotation"] = np.asarray(acc[4], np.float64).reshape(3, 3)
    if acc[5]:
        obj["translation"] = np.asarray(acc[5], np.float64)
    if acc[6]:
        obj["scale"] = np.asarray(acc[6], np.float64)
    return obj


def parse_sequence(data: bytes) -> Dict:
    """Decode a Sequence .pbdata blob → {objects: [...], frame_annotations: [...]}"""
    seq = {"objects": [], "frame_annotations": []}
    for f, w, v in _iter_fields(data):
        if f == 1 and w == 2:
            seq["objects"].append(_parse_object(v))
        elif f == 2 and w == 2:
            seq["frame_annotations"].append(_parse_frame_annotation(v))
    return seq


def frame_to_ndds_dict(seq: Dict, frame_idx: int, resolution_ratio: float = 2.4):
    """Build the DOPE/NDDS-style json dict for one frame (export_to_ndds_file
    parity, data/utils.py:95-290): camera block + per-object pose/keypoints."""
    from scipy.spatial.transform import Rotation as R

    fr = seq["frame_annotations"][frame_idx]
    cam = fr["camera"]
    # Objectron stores resolutions transposed relative to image rows/cols
    # (data/utils.py:85-90).
    height = int(cam.get("image_resolution_width", 1920) / resolution_ratio)
    width = int(cam.get("image_resolution_height", 1440) / resolution_ratio)

    intr = np.asarray(cam.get("intrinsics", np.eye(3)), np.float64).copy()
    intr[:2, :3] /= resolution_ratio
    view = np.asarray(cam.get("view_matrix", np.eye(4)), np.float64)
    proj = np.asarray(cam.get("projection_matrix", np.eye(4)), np.float64)

    out = {
        "camera_data": {
            "width": width,
            "height": height,
            "camera_view_matrix": view.tolist(),
            "camera_projection_matrix": proj.tolist(),
            "intrinsics": {
                # fx/fy and cx/cy swapped like the reference (data/utils.py:115-121).
                "fx": intr[1][1], "fy": intr[0][0],
                "cx": intr[1][2], "cy": intr[0][2],
            },
        },
        "objects": [],
    }
    if fr.get("plane_center") is not None:
        out["AR_data"] = {
            "plane_center": list(fr["plane_center"]),
            "plane_normal": list(fr["plane_normal"]),
        }

    for ann in fr["annotations"]:
        oid = ann["object_id"]
        obj = seq["objects"][oid] if oid < len(seq["objects"]) else None
        kps2d = np.asarray([kp["point_2d"][:2] for kp in ann["keypoints"]])
        kps3d = [kp["point_3d"] for kp in ann["keypoints"]]
        proj_px = (kps2d * np.array([width, height])).astype(int)

        entry = {
            "name": (obj["category"] if obj else "object") + f"_{oid}",
            "projected_cuboid": proj_px.tolist(),
            "keypoints_3d": [list(p) for p in kps3d],
            "visibility": ann["visibility"],
        }
        if obj is not None and obj["rotation"] is not None:
            m_o2w = np.eye(4)
            m_o2w[:3, :3] = obj["rotation"]
            m_o2w[:3, 3] = obj["translation"]
            m_o2c = view @ m_o2w  # M_w2c @ M_o2w (data/utils.py:157-161)
            entry["location"] = m_o2c[:3, 3].tolist()
            entry["quaternion_xyzw"] = R.from_matrix(m_o2c[:3, :3]).as_quat().tolist()
            entry["scale"] = obj["scale"].tolist()
        out["objects"].append(entry)
    return out
