"""The PyTorch package's evaluation modules against the JAX package's, on the
CPU: the same numpy inputs, made from a seed, through each JAX function and
its counterpart in `centerpose_tpu_torch`.

* `evaluation/metrics.py`: hit/miss records and confidence-ranked AP over
  random records (ties in confidence included), and every metric definition,
  equal to 1e-12 (both are float64 numpy).
* `evaluation/iou3d.py` on oriented boxes that overlap, are disjoint or
  nested, and the symmetry sweep over 1, 4 and 12 rotations: the port's C++
  library (`native/iou3d.cpp`, its own copy of the JAX package's source,
  built with the same flags) equals the JAX package's library bit for bit;
  the port's numpy path (`use_native=False`), the JAX package's numpy path
  to the bit, is within 1e-8 of both: its qhull hull volume and the
  library's divergence-theorem volume differ by up to 4.3e-9 on these boxes
  (40 seeds of each kind; 1e-9 does not hold).
* `evaluation/mobilepose.py::lift_2d_to_3d` to 1e-9; `evaluation/relabel.py`
  on hand-written list files and `data/objectron_pb.py` on the bytes that
  `tests/test_objectron_pb.py` builds: equal.
* `evaluation/evaluator.py::Evaluator`: the same pnp_shell quintuples,
  planted from seeded ground truth (exact, off by a few pixels, wrong in
  scale, false positives), through both evaluators give `report_dict`s equal
  to 1e-12 and the same text report, with the C++ IoU on both sides: a plain
  category, the symmetric ones (bottle; cup with `eval_mug_symmetric` 0 and
  1), `re_pnp` with a deterministic stand-in, video mode with the
  consistency score, and `save_stats` -> `load_and_merge` across the
  packages in both directions.
"""

import ctypes
import gc
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from centerpose_tpu import native as jax_native
from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.data import objectron_pb as jax_pb
from centerpose_tpu.evaluation import evaluator as jax_ev
from centerpose_tpu.evaluation import iou3d as jax_iou
from centerpose_tpu.evaluation import metrics as jax_metrics
from centerpose_tpu.evaluation import mobilepose as jax_mobilepose
from centerpose_tpu.evaluation import relabel as jax_relabel
from centerpose_tpu_torch import native
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import objectron_pb
from centerpose_tpu_torch.evaluation import evaluator, iou3d, metrics, mobilepose, relabel
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from tests.test_objectron_pb import _make_sequence

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12
FX, FY, CX, CY, WIDTH, HEIGHT = 500.0, 480.0, 320.0, 240.0, 640, 480


def release_memory():
    """Hand this file's memory back before the worker's next file."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):          # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def _release():
    yield
    release_memory()


def assert_same(a, b, tol=TOL, where="report"):
    """Nested dicts / lists / numbers / arrays equal, floats within `tol`."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, (list, tuple)) or isinstance(a, np.ndarray) and a.dtype == object:
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, (float, np.floating, np.ndarray)) and not isinstance(a, bool):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, where
        assert np.allclose(a, b, rtol=0.0, atol=tol, equal_nan=True), (where, a, b)
    else:
        assert a == b, (where, a, b)


# -------------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", range(4))
def test_hit_miss_and_average_precision(seed):
    rng = np.random.RandomState(seed)
    values = rng.uniform(-0.2, 1.2, 60)
    confs = np.round(rng.uniform(0, 1, 60), 1)          # ties: the sort must be stable
    greater = bool(seed % 2)
    thresholds = jax_metrics.THRESH_3D_IOU if greater else jax_metrics.THRESH_SCALE
    jh, ph = jax_metrics.HitMiss(thresholds), metrics.HitMiss(thresholds)
    for v, c in zip(values, confs):
        jh.record_hit_miss(float(v), float(c), greater=greater)
        ph.record_hit_miss(float(v), float(c), greater=greater)
    assert ph.records == jh.records
    for num_gt in (0, 7, 40, 60, 75):
        jap, pap = jax_metrics.AveragePrecision(num_gt), metrics.AveragePrecision(num_gt)
        assert_same(pap.compute(ph), jap.compute(jh))
        assert abs(pap.at_threshold(ph, 0.5) - jap.at_threshold(jh, 0.5)) <= TOL


def _box(rng, depth=(1.5, 3.0)):
    """A random box in the OpenGL camera frame (camera looking down -z):
    rotation, translation, scale, and its 9 points (center first)."""
    r = Rotation.from_euler("yx", [rng.uniform(-np.pi, np.pi), rng.uniform(-0.4, 0.4)]).as_matrix()
    t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), -rng.uniform(*depth)])
    s = rng.uniform(0.1, 0.5, 3)
    pts = np.vstack([t[None], cuboid_vertices(s) @ r.T + t])
    return r, t, s, pts


def _project(pts):
    """OpenGL camera frame -> normalized image coordinates [N, 2]."""
    z = -pts[:, 2]
    return np.stack([(FX * pts[:, 0] / z + CX) / WIDTH, (-FY * pts[:, 1] / z + CY) / HEIGHT], -1)


@pytest.mark.parametrize("seed", range(5))
def test_metric_definitions(seed):
    rng = np.random.RandomState(10 + seed)
    r1, t1, s1, p1 = _box(rng)
    r2, t2, s2, p2 = _box(rng)
    k1, k2 = _project(p1), _project(p2)
    mo2c = np.eye(4)
    mo2c[:3, :3], mo2c[:3, 3] = r1, t1
    pairs = [
        (metrics.scale_error(s2, s1), jax_metrics.scale_error(s2, s1)),
        (metrics.fit_projection(p1, k1), jax_metrics.fit_projection(p1, k1)),
        (metrics.pixel_error_2d(k2, k1), jax_metrics.pixel_error_2d(k2, k1)),
        (metrics.pixel_error_2d(k2, k1, 4), jax_metrics.pixel_error_2d(k2, k1, 4)),
        (metrics.pixel_error_2d(k2, k1, 12, p1, mo2c), jax_metrics.pixel_error_2d(k2, k1, 12, p1, mo2c)),
        (metrics.viewpoint_angles(r2), jax_metrics.viewpoint_angles(r2)),
        (metrics.viewpoint_angles(r2, t2), jax_metrics.viewpoint_angles(r2, t2)),
        (metrics.azimuth_polar_error(r2, r1, 1, t2, t1), jax_metrics.azimuth_polar_error(r2, r1, 1, t2, t1)),
        (metrics.azimuth_polar_error(r2, r1, 100, t2, t1),
         jax_metrics.azimuth_polar_error(r2, r1, 100, t2, t1)),
        (metrics.add_metric(p2, p1), jax_metrics.add_metric(p2, p1)),
        (metrics.adds_metric(p2, p1), jax_metrics.adds_metric(p2, p1)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert_same(got, want, where=f"metric {i}")


# ---------------------------------------------------------------------- IoU
def _iou_case(kind, seed):
    """Two OrientedBoxes (rotation, translation, scale) of one kind."""
    rng = np.random.RandomState(100 + seed)
    r1 = Rotation.random(random_state=rng).as_matrix()
    s1 = rng.uniform(0.5, 1.5, 3)
    t1 = rng.uniform(-1, 1, 3)
    if kind == "overlapping":
        r2 = r1 @ Rotation.from_euler("y", rng.uniform(0.1, 1.0)).as_matrix()
        t2, s2 = t1 + rng.uniform(-0.2, 0.2, 3), s1 * rng.uniform(0.8, 1.2, 3)
    elif kind == "partial":
        r2 = Rotation.random(random_state=rng).as_matrix()
        t2, s2 = t1 + rng.uniform(-0.6, 0.6, 3), rng.uniform(0.5, 1.5, 3)
    elif kind == "disjoint":
        r2 = Rotation.random(random_state=rng).as_matrix()
        t2, s2 = t1 + np.array([5.0, 0.0, 0.0]), s1
    else:                                   # nested: a small box well inside
        r2 = Rotation.random(random_state=rng).as_matrix()
        t2, s2 = t1, s1.min() * rng.uniform(0.2, 0.4, 3)
    return (r1, t1, s1), (r2, t2, s2)


@pytest.mark.parametrize("rotations", (1, 4, 12))
@pytest.mark.parametrize("kind", ("overlapping", "partial", "disjoint", "nested"))
def test_box_iou_native_bits_and_numpy(kind, rotations):
    for seed in range(3):
        a, b = _iou_case(kind, seed)
        pa, pb = iou3d.OrientedBox(*a), iou3d.OrientedBox(*b)
        if rotations == 1:
            jax_lib = jax_native.iou3d_native(*a, *b)
            port_lib = iou3d.box_iou_3d(pa, pb)
            port_np = iou3d.box_iou_3d(pa, pb, use_native=False)
            jax_np = jax_iou.box_iou_3d(jax_iou.OrientedBox(*a), jax_iou.OrientedBox(*b),
                                        use_native=False)
            assert port_np == jax_np
        else:
            jax_lib = jax_native.iou3d_sweep_native(*a, *b, rotations)
            port_lib = iou3d.iou_with_symmetry_sweep(pa, pb, rotations)
            port_np = iou3d.iou_with_symmetry_sweep(pa, pb, rotations, use_native=False)
        assert jax_lib is not None, "the JAX package's native library did not build"
        assert port_lib == jax_lib, (kind, seed, port_lib, jax_lib)       # the same bits
        assert abs(port_np - port_lib) <= 1e-8, (kind, seed, port_np, port_lib)
        if kind == "disjoint":
            assert port_lib == 0.0
        if kind == "nested":
            assert port_lib == pytest.approx(np.prod(b[2]) / np.prod(a[2]), abs=1e-12)


def test_native_library_is_built_from_the_package_source(tmp_path, monkeypatch):
    """The port's copy of the source has the JAX package's code (comments
    aside); the library's name carries a hash of the source and the flags;
    a build that fails, or finds no compiler, raises (no quiet fallback);
    the CUDA build's sources stay the `.cu` files."""
    from centerpose_tpu_torch import _build

    def code(path):
        return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]

    assert code(native.SOURCE) == code(REPO / "native" / "iou3d.cpp")
    path = native.library_path()
    assert path.parent == _build.BUILD and path.name.startswith("libiou3d-")
    native.get_lib()
    assert path.is_file()
    assert _build.sources() == ["dcn_v2_bwd", "dcn_v2_fwd"]

    broken = tmp_path / "iou3d.cpp"
    broken.write_text("double iou3d( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._compile(tmp_path / "lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native._compile(tmp_path / "lib.so")
    assert not list(tmp_path.glob("*.so*"))


@pytest.mark.parametrize("seed", range(3))
def test_oriented_box_fit(seed):
    rng = np.random.RandomState(200 + seed)
    _, _, _, pts = _box(rng)
    corners = pts[1:] + rng.normal(0, 0.01, (8, 3))
    got = iou3d.OrientedBox.from_corners_fit(corners)
    want = jax_iou.OrientedBox.from_corners_fit(corners)
    for name in ("rotation", "translation", "scale"):
        assert_same(getattr(got, name), getattr(want, name), where=name)
    assert_same(got.corners(), want.corners())


# --------------------------------------------------------------- mobilepose
@pytest.mark.parametrize("seed", range(3))
def test_lift_2d_to_3d(seed):
    rng = np.random.RandomState(300 + seed)
    _, _, _, pts = _box(rng)
    px = _project(pts)[1:] * [WIDTH, HEIGHT] + rng.normal(0, 1.5, (8, 2))
    cam = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    got = mobilepose.lift_2d_to_3d(px, cam, WIDTH, HEIGHT)
    want = jax_mobilepose.lift_2d_to_3d(px, cam, WIDTH, HEIGHT)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-9


# ------------------------------------------------------------------ relabel
def _label_dir(root):
    for sub, name, lines in (
        ("cup", "cup_list.txt", ["cup_batch-1_1\t0", "cup_batch-2_5\t1", ""]),
        ("cup", "mug_left_list.txt", ["cup_batch-3_2\t0", "cup_batch-2_5\t0"]),
        ("cup", "mug_right_list.txt", ["cup_batch-4_4\t0\t\textra"]),
        ("chair", "symmetric_list.txt", ["chair_batch-9_9\t1"]),
    ):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / name).write_text("\n".join(lines) + "\n")
    return str(root)


def test_relabel_lists(tmp_path, monkeypatch):
    label_dir = _label_dir(tmp_path / "label")
    jl, pl = jax_relabel.RelabelLists.from_dir(label_dir), relabel.RelabelLists.from_dir(label_dir)
    for name in ("cup", "mug_left", "mug_right", "chair_symmetric"):
        assert getattr(pl, name) == getattr(jl, name), name
    monkeypatch.setenv("CENTERPOSE_LABEL_DIR", label_dir)
    assert relabel.RelabelLists.resolve().cup == jax_relabel.RelabelLists.resolve().cup == jl.cup
    monkeypatch.delenv("CENTERPOSE_LABEL_DIR")
    assert relabel.RelabelLists.resolve() is None and jax_relabel.RelabelLists.resolve() is None
    for lists in (relabel.RelabelLists, jax_relabel.RelabelLists):
        with pytest.raises(FileNotFoundError):
            lists.resolve(str(tmp_path / "missing"))

    rng = np.random.RandomState(4)
    for video in ("cup_batch-1_1", "cup_batch-2_5", "cup_batch-3_2", "cup_batch-4_4", "chair_batch-9_9"):
        assert (pl.mug_flags(video, 3) == jl.mug_flags(video, 3)).all()
        assert (pl.chair_symmetric_flags(video, 3) == jl.chair_symmetric_flags(video, 3)).all()
        p2, p3, rot = rng.rand(3, 9, 3), rng.rand(3, 9, 3), rng.rand(3, 3, 3)
        jp2, jp3, jrot = p2.copy(), p3.copy(), rot.copy()
        flags = pl.apply_mug_relabel(video, p2, p3, rot)
        assert (flags == jl.apply_mug_relabel(video, jp2, jp3, jrot)).all()
        assert (p2 == jp2).all() and (p3 == jp3).all() and (rot == jrot).all()
    for flags in ([], [True], [False], [True, False], [False, False], [True, True]):
        assert relabel.route_mug_detector(flags) == jax_relabel.route_mug_detector(flags)
        for mug_only in (None, True, False):
            assert relabel.mug_only_skip(flags, mug_only) == jax_relabel.mug_only_skip(flags, mug_only)


# --------------------------------------------------------------- objectron
def test_objectron_sequence_and_ndds_frame():
    data, _, _ = _make_sequence()
    seq = objectron_pb.parse_sequence(data)
    assert_same(seq, jax_pb.parse_sequence(data), tol=0.0)
    for ratio in (1.0, 2.4):
        assert_same(objectron_pb.frame_to_ndds_dict(seq, 0, ratio),
                    jax_pb.frame_to_ndds_dict(jax_pb.parse_sequence(data), 0, ratio), tol=0.0)


# ---------------------------------------------------------------- evaluator
def _instances(rng, n, mug_flags=None):
    out = []
    for i in range(n):
        r, t, s, pts = _box(rng)
        out.append({"kps_2d_norm": _project(pts), "kps_3d_cam": pts, "scale": s, "rotation": r,
                    "translation": t, "visibility": 0.3 if rng.rand() < 0.15 else 1.0,
                    "mug": None if mug_flags is None else bool(mug_flags[i])})
    return out


def _plane(inst):
    """The ground plane under an instance: normal its up axis, through its
    bottom face's center."""
    up = inst["rotation"][:, 1]
    return inst["translation"] - up * inst["scale"][1] / 2, up


def _quintuple(rng, inst, kind, score):
    """A pnp_shell quintuple planted from one GT instance."""
    r, t, s = inst["rotation"], inst["translation"], inst["scale"]
    if kind == "pixels":
        r = r @ Rotation.from_euler("y", rng.uniform(-0.1, 0.1)).as_matrix()
    elif kind == "scale":
        s = s * np.array([1.3, 1.0, 0.8])
    elif kind == "false":
        r, t, s, _ = _box(rng)
    pts = np.vstack([t[None], cuboid_vertices(s) @ r.T + t])
    proj = _project(pts)
    kps = proj + (rng.normal(0, 3.0 / WIDTH, proj.shape) if kind != "exact" else 0.0)
    det = {"score": score, "pose": (r, t)}
    # Up to scale, as PnP gives it: the plane recovers the metric scale.
    return proj.copy(), pts * 0.5, s / s[1], kps, det


def _re_pnp(det, gt_scale):
    """A deterministic stand-in for `--eval_gt_scale`'s re-run PnP: the
    detection's pose with the matched GT's scale; none for weak scores."""
    if det["score"] < 0.3:
        return None
    r, t = det["pose"]
    pts = np.vstack([t[None], cuboid_vertices(gt_scale) @ r.T + t])
    return _project(pts), pts


def _scenes(seed, n_images, mug=False, video=False):
    """[(instances, boxes, plane, frame_id, video_key)] from one seed: video
    mode moves each video's instances a little from frame to frame."""
    rng = np.random.RandomState(seed)
    scenes, insts = [], None
    for i in range(n_images):
        frame = i % 4
        if insts is None or not video or frame == 0:
            n = rng.randint(1, 4)
            insts = _instances(rng, n, rng.rand(n) < 0.5 if mug else None)
        else:
            for inst in insts:
                step = rng.normal(0, 0.01, 3)
                inst["translation"] = inst["translation"] + step
                inst["kps_3d_cam"] = inst["kps_3d_cam"] + step
                inst["kps_2d_norm"] = _project(inst["kps_3d_cam"])
        boxes = []
        for inst in insts:
            kind = ("exact", "pixels", "scale", "false")[rng.randint(4)]
            boxes.append(_quintuple(rng, inst, kind, round(float(rng.uniform(0.1, 1.0)), 2)))
        if rng.rand() < 0.5:
            boxes.append(_quintuple(rng, insts[0], "false", round(float(rng.uniform(0.1, 0.5)), 2)))
        plane = _plane(insts[0]) if rng.rand() < 0.8 else None
        scenes.append((insts, boxes, plane, frame if video else None, f"v{i // 4}"))
    return scenes


def _run(module, ev, scenes, re_pnp=None):
    for insts, boxes, plane, frame_id, key in scenes:
        gts = [module.GroundTruthInstance(**inst) for inst in insts]
        ev.evaluate_image(boxes, gts, plane, frame_id=frame_id, re_pnp=re_pnp, video_key=key)
    return ev


EVAL_CASES = {
    "shoe": dict(category="shoe"),
    "bottle": dict(category="bottle"),
    "cup_mug_symmetric": dict(category="cup", mug=True, eval_mug_symmetric=True),
    "cup_mug_not_symmetric": dict(category="cup", mug=True, eval_mug_symmetric=False),
    "re_pnp": dict(category="shoe", re_pnp=True),
    "video": dict(category="camera", video=True),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluator_report(case):
    spec = dict(EVAL_CASES[case])
    category = spec.pop("category")
    scenes = _scenes(7, 12, mug=spec.get("mug", False), video=spec.get("video", False))
    kw = {"eval_mug_symmetric": spec["eval_mug_symmetric"]} if "eval_mug_symmetric" in spec else {}
    re_pnp = _re_pnp if spec.get("re_pnp") else None
    port = _run(evaluator, evaluator.Evaluator(preset("centerpose", category=category), **kw),
                scenes, re_pnp)
    ref = _run(jax_ev, jax_ev.Evaluator(jax_preset("centerpose", category=category), **kw),
               scenes, re_pnp)
    assert port.eval_num_symmetry == ref.eval_num_symmetry == (100 if category in ("bottle", "cup") else 1)
    got, want = port.report_dict(), ref.report_dict()
    assert got["num_gt"] > 0 and got["num_pred"] > got["num_gt"] // 2
    assert 0.0 < got["families"]["iou3d"]["ap"]            # some matches are right
    assert ("consistency" in got) == bool(spec.get("video"))
    assert_same(got, want)
    assert port.report() == ref.report()
    assert_same(port.compute_aps(), ref.compute_aps())


def test_evaluator_stats_across_packages(tmp_path):
    """Half the images in each package's evaluator; each loads the other
    package's saved stats: both equal one evaluator that saw every image."""
    scenes = _scenes(11, 12)
    cfg, jcfg = preset("centerpose", category="chair"), jax_preset("centerpose", category="chair")
    whole = _run(evaluator, evaluator.Evaluator(cfg), scenes).report_dict()
    port_half = _run(evaluator, evaluator.Evaluator(cfg), scenes[6:])
    jax_half = _run(jax_ev, jax_ev.Evaluator(jcfg), scenes[6:])
    port_half.save_stats(str(tmp_path / "port.json"))
    jax_half.save_stats(str(tmp_path / "jax.json"))
    port = _run(evaluator, evaluator.Evaluator(cfg), scenes[:6])
    port.load_and_merge(str(tmp_path / "jax.json"))
    ref = _run(jax_ev, jax_ev.Evaluator(jcfg), scenes[:6])
    ref.load_and_merge(str(tmp_path / "port.json"))
    assert_same(port.report_dict(), ref.report_dict())
    assert_same(port.report_dict(), whole)
    assert port.num_pred == ref.num_pred == whole["num_pred"]


def test_parse_gt_json_and_plane_scale(tmp_path):
    from centerpose_tpu_torch.data.synthetic import generate_dataset

    paths = generate_dataset(str(tmp_path), n_videos=1, frames_per_video=2, seed=3,
                             width=160, height=120)
    for png in paths:
        path = png[:-4] + ".json"
        got, want = evaluator.parse_gt_json(path), jax_ev.parse_gt_json(path)
        assert len(got[0]) == len(want[0]) > 0
        for g, w in zip(got[0], want[0]):
            assert_same(vars(g), vars(w), tol=0.0)
        assert_same(got[1], want[1], tol=0.0)
        assert_same(got[2], want[2], tol=0.0)
        box = got[0][0].kps_3d_cam * 0.7
        assert evaluator.compute_plane_scale(box, got[1]) == jax_ev.compute_plane_scale(box, want[1])
