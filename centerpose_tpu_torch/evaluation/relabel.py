"""Manual cup/mug (and chair symmetry) relabel lists.

The Objectron 'cup' category mixes true cups and mugs; the reference ships
hand-labeled lists that (a) split every (video, object) into cup vs mug, and
(b) mark mugs whose annotation has the handle on the LEFT — those get their
cuboid keypoints mirrored so all mugs share one handedness. The lists feed
three places in the reference:

  * the eval tf.Example parser (`objectron/dataset/parser.py:24-44,157-185`):
    per-object MugFlag + keypoint/rotation relabel of the GT;
  * detector routing in the image evaluator
    (`eval_image_official.py:166-226,297-304`): cup samples run the mug model
    or the cup model depending on the flags;
  * offline preprocessing (`data/utils.py:21-47,195-297`): the DOPE-style
    jsons carry per-object `mug`/`symmetric` booleans consumed at train time.

File format (tab-separated, one entry per line): `<video_name>\t<object_id>`
where video_name is the tfrecord image filename with '/' replaced by '_'
(e.g. `cup_batch-30_31`). The list directory is the reference's
`label/cup/{cup_list,mug_left_list,mug_right_list}.txt` +
`label/chair/symmetric_list.txt` layout; point `--label_dir` (or
$CENTERPOSE_LABEL_DIR) at such a directory.

The PyTorch package's copy of `centerpose_tpu/evaluation/relabel.py`.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence, Set, Tuple

import numpy as np

# Keypoint index pairs swapped when mirroring a left-handled mug
# (parser.py:48 swap_list) — 1-indexed over the 9-point cuboid (0 = center).
SWAP_PAIRS: Tuple[Tuple[int, int], ...] = ((1, 6), (2, 5), (3, 8), (4, 7))

# Mirror matrix applied to the object->camera rotation for left-handled mugs
# (parser.py:52-54): R_new = inv(M) @ R_old with M = diag(-1, 1, -1).
MIRROR_M = np.diag([-1.0, 1.0, -1.0])


def _read_list(path: str) -> Set[Tuple[str, str]]:
    """Read one tab-separated (video_name, object_id) list file."""
    entries: Set[Tuple[str, str]] = set()
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            parts = re.split(r"\t+", line)
            if len(parts) >= 2:
                entries.add((parts[0], parts[1]))
    return entries


class RelabelLists:
    """Loaded relabel lists + the per-sample operations they drive."""

    def __init__(
        self,
        cup: Optional[Set[Tuple[str, str]]] = None,
        mug_left: Optional[Set[Tuple[str, str]]] = None,
        mug_right: Optional[Set[Tuple[str, str]]] = None,
        chair_symmetric: Optional[Set[Tuple[str, str]]] = None,
    ):
        self.cup = cup or set()
        self.mug_left = mug_left or set()
        self.mug_right = mug_right or set()
        self.chair_symmetric = chair_symmetric or set()

    @classmethod
    def from_dir(cls, label_dir: str) -> "RelabelLists":
        """Load from a reference-layout label directory
        (label/cup/*.txt + label/chair/symmetric_list.txt)."""

        def maybe(path: str) -> Set[Tuple[str, str]]:
            return _read_list(path) if os.path.exists(path) else set()

        return cls(
            cup=maybe(os.path.join(label_dir, "cup", "cup_list.txt")),
            mug_left=maybe(os.path.join(label_dir, "cup", "mug_left_list.txt")),
            mug_right=maybe(os.path.join(label_dir, "cup", "mug_right_list.txt")),
            chair_symmetric=maybe(
                os.path.join(label_dir, "chair", "symmetric_list.txt")
            ),
        )

    @classmethod
    def resolve(cls, label_dir: Optional[str] = None) -> Optional["RelabelLists"]:
        """Resolve a label dir from the argument or $CENTERPOSE_LABEL_DIR;
        None when neither is set (cup eval then treats everything as mug,
        matching an empty cup_list). A dir that WAS configured but does not
        exist raises — silently degrading a typo'd --label_dir to all-mug
        routing would skew every cup metric."""
        d = label_dir or os.environ.get("CENTERPOSE_LABEL_DIR")
        if not d:
            return None
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"relabel label_dir {d!r} is not a directory (from "
                f"{'--label_dir' if label_dir else '$CENTERPOSE_LABEL_DIR'})"
            )
        return cls.from_dir(d)

    # ------------------------------------------------------------------ flags
    def mug_flags(self, video_name: str, num_objects: int) -> np.ndarray:
        """Per-object mug flag: True unless (video, id) is in the cup list
        (parser.py:159-165 — mug is the default)."""
        return np.array(
            [(video_name, str(i)) not in self.cup for i in range(num_objects)],
            bool,
        )

    def chair_symmetric_flags(self, video_name: str, num_objects: int) -> np.ndarray:
        """Per-object chair symmetry flag (data/utils.py:294-297)."""
        return np.array(
            [(video_name, str(i)) in self.chair_symmetric for i in range(num_objects)],
            bool,
        )

    # ---------------------------------------------------------------- relabel
    def apply_mug_relabel(
        self,
        video_name: str,
        points_2d: np.ndarray,   # [N, 9, 2+] — modified in place per object
        points_3d: np.ndarray,   # [N, 9, 3]
        rotations: Optional[np.ndarray] = None,  # [N, 3, 3] object→camera
    ) -> np.ndarray:
        """Mirror left-handled mugs' GT (parser.py:157-185): swap the four
        keypoint pairs in 2D and 3D and left-multiply the rotation by
        inv(MIRROR_M). Returns the per-object mug flags."""
        n = points_2d.shape[0]
        flags = self.mug_flags(video_name, n)
        for i in range(n):
            if not flags[i]:
                continue
            if (video_name, str(i)) in self.mug_left:
                for a, b in SWAP_PAIRS:
                    points_2d[i, [a, b]] = points_2d[i, [b, a]]
                    points_3d[i, [a, b]] = points_3d[i, [b, a]]
                if rotations is not None:
                    rotations[i] = np.linalg.inv(MIRROR_M) @ rotations[i]
        return flags


def route_mug_detector(mug_flags: Sequence[bool]) -> bool:
    """Sample-level detector routing (eval_image_official.py:297-304):
    True → run the MUG detector; False → run the CUP detector. All-mug and
    MIXED samples go to the mug detector; all-cup samples to the cup one."""
    flags = np.asarray(mug_flags, bool)
    if flags.size == 0:
        return True
    if bool(np.all(~flags)):
        return False
    return True


def mug_only_skip(mug_flags: Sequence[bool], mug_only: Optional[bool]) -> bool:
    """Sample-level mug_only filtering (eval_image_official.py:336-346):
    mug_only=True skips all-cup samples; mug_only=False skips any sample
    containing a mug; None evaluates everything. Returns True → skip."""
    if mug_only is None:
        return False
    flags = np.asarray(mug_flags, bool)
    if mug_only:
        return bool(np.all(~flags)) if flags.size else True
    return not bool(np.all(~flags))
