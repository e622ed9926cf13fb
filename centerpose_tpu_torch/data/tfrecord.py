"""Dependency-free TFRecord + tf.Example reader for Objectron records.

Parity target: the reference's TF-based record ingestion
(src/tools/objectron_eval/eval_image_official.py:1186-1211 streaming
`gs://objectron/v1/records_shuffled`, parsed by `ObjectronParser`
(objectron/dataset/parser.py:93-228) with the feature-key map of
objectron/schema/features.py). The environment has no TensorFlow, so this module
implements the two wire formats directly:

  * TFRecord framing: per record — uint64-LE length, masked-CRC32C(length),
    payload, masked-CRC32C(payload). CRCs are verified when requested.
  * tf.Example protobuf: Example{1: Features{1: map<string, Feature>}} where
    Feature is oneof {1: BytesList, 2: FloatList, 3: Int64List}; a ~100-line
    wire-format parser covers exactly these shapes.

Only the feature keys the evaluator consumes are surfaced (image, 2D/3D points,
instance counts, scales, poses, visibility, camera matrices, plane).

The PyTorch package's own copy of `centerpose_tpu/data/tfrecord.py` (the
TensorBoard writer `utils/tbevents.py` frames its records with it), and of
`scripts/synth_to_tfrecords.py`'s packing of DOPE frames into records
(`pack_dope_video`, `pack_dope_dataset`).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------- CRC32C
_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != crc:
                    raise IOError(f"corrupt length CRC in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated record in {path}")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if _masked_crc(data) != crc:
                    raise IOError(f"corrupt data CRC in {path}")
            yield data


# ---------------------------------------------------------------- proto wire
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, value_bytes|varint) from a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wtype, val
        elif wtype == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, wtype, buf[pos : pos + length]
            pos += length
        elif wtype == 5:  # 32-bit
            yield field, wtype, buf[pos : pos + 4]
            pos += 4
        elif wtype == 1:  # 64-bit
            yield field, wtype, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")


class Feature:
    __slots__ = ("bytes_list", "float_list", "int64_list")

    def __init__(self):
        self.bytes_list: List[bytes] = []
        self.float_list: List[float] = []
        self.int64_list: List[int] = []


def _parse_feature(buf: bytes) -> Feature:
    feat = Feature()
    for field, wtype, val in _iter_fields(buf):
        if field == 1:  # BytesList
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    feat.bytes_list.append(v2)
        elif field == 2:  # FloatList (packed or repeated)
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        feat.float_list.extend(
                            np.frombuffer(v2, dtype="<f4").tolist()
                        )
                    else:
                        feat.float_list.append(
                            struct.unpack("<f", v2)[0]
                        )
        elif field == 3:  # Int64List
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed varints
                        pos = 0
                        while pos < len(v2):
                            iv, pos = _read_varint(v2, pos)
                            feat.int64_list.append(iv)
                    else:
                        feat.int64_list.append(v2)
    return feat


def parse_example(buf: bytes) -> Dict[str, Feature]:
    """tf.Example bytes → {feature_name: Feature}."""
    fm: Dict[str, Feature] = {}
    for field, _, val in _iter_fields(buf):
        if field != 1:  # Example.features
            continue
        for f2, _, v2 in _iter_fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            feat = None
            for f3, _, v3 in _iter_fields(v2):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feat = _parse_feature(v3)
            if key is not None and feat is not None:
                fm[key] = feat
    return fm


def write_tfrecord(path: str, payloads) -> None:
    """Write raw record payloads with masked CRCs (the inverse of read_tfrecord);
    used by the per-video re-sorter (prepare_test_video.py parity)."""
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def _write_varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _len_field(num: int, payload: bytes) -> bytes:
    return _write_varint((num << 3) | 2) + _write_varint(len(payload)) + payload


def make_example(features: Dict[str, tuple]) -> bytes:
    """Serialize {key: (kind, values)} into tf.Example bytes — the writer-side
    counterpart of parse_example (kind ∈ bytes|float|int64). Used by the
    DOPE→tfrecord packer (`pack_dope_video`) and test fixtures."""
    entries = b""
    for key, (kind, values) in features.items():
        if kind == "bytes":
            feat = _len_field(1, b"".join(_len_field(1, v) for v in values))
        elif kind == "float":
            packed = b"".join(struct.pack("<f", float(v)) for v in values)
            feat = _len_field(2, _len_field(1, packed))
        else:
            packed = b"".join(_write_varint(int(v)) for v in values)
            feat = _len_field(3, _len_field(1, packed))
        entry = _len_field(1, key.encode()) + _len_field(2, feat)
        entries += _len_field(1, entry)
    return _len_field(1, entries)  # Example.features


# ------------------------------------------------------------ objectron layer
KEYS = {
    "IMAGE_ENCODED": "image/encoded",
    "IMAGE_FILENAME": "image/filename",
    "IMAGE_ID": "image/id",
    "IMAGE_WIDTH": "image/width",
    "IMAGE_HEIGHT": "image/height",
    "POINT_2D": "point_2d",
    "POINT_3D": "point_3d",
    "POINT_NUM": "point_num",
    "INSTANCE_NUM": "instance_num",
    "OBJECT_TRANSLATION": "object/translation",
    "OBJECT_ORIENTATION": "object/orientation",
    "OBJECT_SCALE": "object/scale",
    "VISIBILITY": "object/visibility",
    "PROJECTION_MATRIX": "camera/projection",
    "VIEW_MATRIX": "camera/view",
    "INTRINSIC_MATRIX": "camera/intrinsics",
    "PLANE_CENTER": "plane/center",
    "PLANE_NORMAL": "plane/normal",
}


def parse_objectron_example(buf: bytes) -> Dict[str, object]:
    """Decode one Objectron tf.Example into numpy-friendly fields
    (ObjectronParser.parse semantics, objectron/dataset/parser.py:93-228)."""
    fm = parse_example(buf)

    def floats(key, shape=None):
        k = KEYS[key]
        if k not in fm:
            return None
        arr = np.asarray(fm[k].float_list, np.float64)
        return arr.reshape(shape) if shape else arr

    out: Dict[str, object] = {}
    if KEYS["IMAGE_ENCODED"] in fm:
        out["image_bytes"] = fm[KEYS["IMAGE_ENCODED"]].bytes_list[0]
    if KEYS["IMAGE_FILENAME"] in fm:
        out["filename"] = fm[KEYS["IMAGE_FILENAME"]].bytes_list[0].decode("utf-8")
    if KEYS["IMAGE_ID"] in fm:
        out["image_id"] = int(fm[KEYS["IMAGE_ID"]].int64_list[0])

    num_instances = (
        int(fm[KEYS["INSTANCE_NUM"]].int64_list[0])
        if KEYS["INSTANCE_NUM"] in fm
        else 0
    )
    point_nums = (
        [int(v) for v in fm[KEYS["POINT_NUM"]].int64_list]
        if KEYS["POINT_NUM"] in fm
        else [9] * num_instances
    )
    out["num_instances"] = num_instances

    p2 = floats("POINT_2D")
    if p2 is not None:
        pts = p2.reshape(-1, 3)
        out["points_2d"] = [
            pts[sum(point_nums[:i]) : sum(point_nums[: i + 1]), :2]
            for i in range(num_instances)
        ]
    p3 = floats("POINT_3D")
    if p3 is not None:
        pts = p3.reshape(-1, 3)
        out["points_3d"] = [
            pts[sum(point_nums[:i]) : sum(point_nums[: i + 1])]
            for i in range(num_instances)
        ]
    scale = floats("OBJECT_SCALE")
    if scale is not None:
        out["scales"] = scale.reshape(num_instances, 3)
    tr = floats("OBJECT_TRANSLATION")
    ori = floats("OBJECT_ORIENTATION")
    if tr is not None and ori is not None:
        out["translations"] = tr.reshape(num_instances, 3)
        out["rotations"] = ori.reshape(num_instances, 3, 3)
    vis = floats("VISIBILITY")
    if vis is not None:
        out["visibilities"] = vis
    for mk, name, shape in (
        ("PROJECTION_MATRIX", "projection", (4, 4)),
        ("VIEW_MATRIX", "view", (4, 4)),
        ("INTRINSIC_MATRIX", "intrinsics", (3, 3)),
    ):
        m = floats(mk)
        if m is not None:
            out[name] = m.reshape(shape)
    pc, pn = floats("PLANE_CENTER"), floats("PLANE_NORMAL")
    if pc is not None and pn is not None:
        out["plane"] = (pc, pn)
    return out


# --------------------------------------------------------- DOPE -> tfrecord
def pack_dope_video(vdir: str, out_path: str, category: str) -> int:
    """One tfrecord of a DOPE video directory's png + json frames, in order,
    in the Objectron layout `parse_objectron_example` reads (the records of
    `scripts/synth_to_tfrecords.py`, byte for byte): `point_2d` as [x / width,
    y / height, 1] per keypoint, points, poses and plane in the OpenGL
    camera frame, `camera/intrinsics` stored transposed as Objectron's are
    (the reader swaps fx/fy and cx/cy back). Returns the number of frames."""
    import glob
    import json
    import os

    from scipy.spatial.transform import Rotation

    payloads = []
    vid = os.path.basename(os.path.normpath(vdir))
    for idx, jpath in enumerate(sorted(glob.glob(os.path.join(vdir, "*.json")))):
        img_path = os.path.splitext(jpath)[0] + ".png"
        if not os.path.exists(img_path):
            continue
        with open(jpath) as f:
            ann = json.load(f)
        with open(img_path, "rb") as f:
            img_bytes = f.read()
        cam = ann["camera_data"]
        w, h, intr = cam["width"], cam["height"], cam["intrinsics"]
        objs = ann.get("objects", [])
        p2, p3, scales, trans, rots = [], [], [], [], []
        for o in objs:
            pc = np.asarray(o["projected_cuboid"], np.float64)[:9]
            p2.extend([pc[i, 0] / w, pc[i, 1] / h, 1.0] for i in range(9))
            p3.extend(np.asarray(o["keypoints_3d"], np.float64)[:9].tolist())
            scales.extend(np.abs(np.asarray(o["scale"], np.float64)).tolist())
            trans.extend(o["location"])
            rots.extend(Rotation.from_quat(o["quaternion_xyzw"]).as_matrix().ravel().tolist())
        features = {
            "image/encoded": ("bytes", [img_bytes]),
            "image/filename": ("bytes", [f"{category}/{vid}/{idx}".encode()]),
            "image/id": ("int64", [idx]),
            "image/width": ("int64", [w]),
            "image/height": ("int64", [h]),
            "instance_num": ("int64", [len(objs)]),
            "point_num": ("int64", [9] * len(objs)),
            "point_2d": ("float", np.asarray(p2, np.float64).ravel().tolist()),
            "point_3d": ("float", np.asarray(p3, np.float64).ravel().tolist()),
            "object/scale": ("float", scales),
            "object/translation": ("float", trans),
            "object/orientation": ("float", rots),
            "object/visibility": ("float", [1.0] * len(objs)),
            "camera/intrinsics": ("float", [intr["fy"], 0.0, intr["cy"], 0.0, intr["fx"],
                                            intr["cx"], 0.0, 0.0, 1.0]),
        }
        if "camera_projection_matrix" in cam:
            features["camera/projection"] = (
                "float", np.asarray(cam["camera_projection_matrix"]).ravel().tolist())
        if "AR_data" in ann:
            features["plane/center"] = ("float", ann["AR_data"]["plane_center"])
            features["plane/normal"] = ("float", ann["AR_data"]["plane_normal"])
        payloads.append(make_example(features))
    write_tfrecord(out_path, payloads)
    return len(payloads)


def pack_dope_dataset(data_dir: str, out_dir: str, category: str) -> List[str]:
    """`pack_dope_video` for every video directory of a DOPE tree:
    `<out_dir>/<video>.tfrecord` each; returns their paths in order."""
    import glob
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for vdir in sorted(d for d in glob.glob(os.path.join(data_dir, "*")) if os.path.isdir(d)):
        paths.append(os.path.join(out_dir, f"{os.path.basename(vdir)}.tfrecord"))
        pack_dope_video(vdir, paths[-1], category)
    return paths
