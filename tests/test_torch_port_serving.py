"""The PyTorch package's serving shell against the JAX package's, on the CPU:
on-device resampling, batched PnP, and the whole `Detector` with weights
carried across; plus the check that the package imports nothing of JAX.
"""

import ast
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu.ops import pnp as jax_pnp
from centerpose_tpu.ops import resample as jax_resample
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.geometry.affine import get_affine_transform
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.inference.detector import DEFAULT_CAMERA, Detector
from centerpose_tpu_torch.models.convert import from_jax_variables
from centerpose_tpu_torch.ops import pnp, resample

from test_torch_port_model import jax_model_and_variables

REPO = pathlib.Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------- resample
def _images_and_transforms(seed, n, h, w, out):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    invs = []
    for i in range(n):
        c = np.array([w / 2.0 + 3 * i, h / 2.0 - 2 * i], np.float32)
        s = max(h, w) * (1.0 + 0.3 * i)   # i > 0 zooms out: zero border shows
        invs.append(get_affine_transform(c, s, 0, (out, out), inv=True))
    return images, np.stack(invs).astype(np.float32)


def test_warp_separable_batch_matches_jax():
    """atol 1e-4 on the normalised output: two f32 matrix products."""
    images, invs = _images_and_transforms(0, 3, 40, 56, 32)
    ref = np.asarray(jax_resample.warp_separable_batch(
        jnp.asarray(images), jnp.asarray(invs), 32, 32))
    out = resample.warp_separable_batch(
        torch.from_numpy(images), torch.from_numpy(invs), 32, 32)
    assert out.shape == (3, 32, 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    # The gather formulation computes the same warp.
    gat = resample._warp_affine_batch(
        torch.from_numpy(images), torch.from_numpy(invs), 32, 32, True)
    np.testing.assert_allclose(gat.numpy(), ref, atol=1e-4, rtol=0)
    raw = resample.warp_axis_aligned_batch(
        torch.from_numpy(images), torch.from_numpy(invs), 32, 32, normalize=False)
    assert float(raw.min()) >= 0.0 and float(raw.max()) <= 255.0


def test_warp_affine_device_matches_jax():
    """A rotated (not axis-aligned) transform through the 4-corner gather."""
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (36, 48, 3)).astype(np.uint8)
    inv = get_affine_transform(
        np.array([24.0, 18.0], np.float32), 48.0, 25.0, (32, 32), inv=True
    ).astype(np.float32)
    assert not resample.axis_aligned([inv])
    for normalize in (True, False):
        ref = np.asarray(jax_resample.warp_affine_device(
            jnp.asarray(image), jnp.asarray(inv), 32, 32, normalize))
        out = resample.warp_affine_device(
            torch.from_numpy(image), torch.from_numpy(inv), 32, 32, normalize)
        np.testing.assert_allclose(
            out.numpy(), ref, atol=1e-4 if normalize else 2e-3, rtol=0)


def test_preprocess_on_device_matches_jax():
    images, invs = _images_and_transforms(2, 2, 30, 44, 32)
    ref = np.asarray(jax_resample.preprocess_on_device(list(images), list(invs), 32, 32))
    out = resample.preprocess_on_device(list(images), list(invs), 32, 32, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    # Images of different shapes go one by one.
    mixed = [images[0], images[1][:20, :30]]
    ref = np.asarray(jax_resample.preprocess_on_device(mixed, list(invs), 32, 32))
    out = resample.preprocess_on_device(mixed, list(invs), 32, 32, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------- pnp
def _rodrigues_np(rvec):
    theta = np.linalg.norm(rvec)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _planted_poses(seed, m, noise=0.0):
    """m cuboids at known poses, projected with the default camera as the 16
    points of rep_mode 1 (displacement and heatmap estimate per corner)."""
    rng = np.random.RandomState(seed)
    cam = DEFAULT_CAMERA.astype(np.float64)
    pts, cubs, rs, ts = [], [], [], []
    for _ in range(m):
        cub = cuboid_vertices(rng.uniform(0.5, 1.5, 3))
        r = _rodrigues_np(rng.randn(3) * 0.8)
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(3.0, 6.0)])
        pc = cub @ r.T + t
        uv = pc[:, :2] / pc[:, 2:] * [cam[0, 0], cam[1, 1]] + [cam[0, 2], cam[1, 2]]
        p16 = np.repeat(uv, 2, axis=0) + rng.randn(16, 2) * noise
        pts.append(p16)
        cubs.append(cub)
        rs.append(r)
        ts.append(t)
    return (np.stack(pts).astype(np.float32), np.stack(cubs).astype(np.float32),
            np.stack(rs), np.stack(ts), cam.astype(np.float32))


def test_solve_pnp_batch_padded_matches_jax():
    """6 objects with all 16 points (noisy), one with 5 points and one with 4
    (the EPnP initialiser), one with 3 (invalid), one with none, against the
    JAX package's padded solve (M = 10 padded to 16 there; the port's solve
    takes any M). `valid` equal; pose atol 1e-3
    (20 LM iterations from initialisers whose eigenvectors differ in sign and
    order between the libraries); projections atol 0.05 px."""
    pts, cubs, rs, ts, cam = _planted_poses(0, 10, noise=0.3)
    clean, *_ = _planted_poses(0, 10, noise=0.0)
    keep5 = [0, 3, 5, 6, 7]
    keep4 = [1, 2, 4, 7]
    for row, keep in ((6, keep5), (7, keep4), (8, [0, 1, 2]), (9, [])):
        pts[row] = clean[row]            # few points: exact data, unique pose
        drop = [i for i in range(16) if i % 2 or i // 2 not in keep]
        pts[row, drop] = -10000.0
    # Per-object intrinsics.
    cams = np.broadcast_to(cam, (10, 3, 3)).copy()
    ref = jax_pnp.solve_pnp_batch_padded(pts, cubs, cams)
    out = pnp.solve_pnp_batch(pts, cubs, cams, device="cpu")
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    assert valid.tolist() == [True] * 8 + [False, False]
    for name in pnp.PnPResult._fields:
        assert tuple(getattr(out, name).shape) == tuple(np.asarray(getattr(ref, name)).shape), name
    v = valid
    for name, atol in (("translation", 1e-3), ("rotation", 1e-3), ("quaternion", 1e-3),
                       ("translation_gl", 1e-3), ("rotation_gl", 1e-3),
                       ("quaternion_gl", 1e-3), ("projected", 0.05), ("reproj_error", 0.05)):
        np.testing.assert_allclose(
            getattr(out, name).numpy()[v], np.asarray(getattr(ref, name))[v],
            atol=atol, rtol=0, err_msg=name,
        )
    # And both found the planted poses of the exact-data rows.
    np.testing.assert_allclose(out.translation.numpy()[6:8], ts[6:8], atol=2e-2)
    np.testing.assert_allclose(out.rotation.numpy()[6:8], rs[6:8], atol=2e-2)
    # A shared [3, 3] camera gives the same answer as per-object copies.
    shared = pnp.solve_pnp_batch(pts, cubs, cam, device="cpu")
    np.testing.assert_allclose(
        shared.translation.numpy()[v], out.translation.numpy()[v], atol=1e-4)


def test_solve_pnp_single_and_helpers_match_jax():
    pts, cubs, rs, ts, cam = _planted_poses(1, 1, noise=0.0)
    ref = jax_pnp.solve_pnp_single(jnp.asarray(pts[0]), jnp.asarray(cubs[0]), jnp.asarray(cam))
    out = pnp.solve_pnp_single(pts[0], cubs[0], cam, device="cpu")
    assert bool(out.valid) and bool(ref.valid)
    np.testing.assert_allclose(out.translation.numpy(), ts[0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.translation.numpy(), np.asarray(ref.translation), atol=1e-3)
    rvec = np.random.RandomState(2).randn(5, 3).astype(np.float32)
    rot = pnp.rodrigues(torch.from_numpy(rvec))
    quat = pnp.rotation_to_quaternion(rot)
    for i in range(5):
        np.testing.assert_allclose(
            rot[i].numpy(), np.asarray(jax_pnp.rodrigues(jnp.asarray(rvec[i]))), atol=1e-6)
        np.testing.assert_allclose(
            quat[i].numpy(),
            np.asarray(jax_pnp.rotation_to_quaternion(jnp.asarray(rot[i].numpy()))), atol=1e-6)
    assert torch.equal(pnp.rodrigues(torch.zeros(3)), torch.eye(3))


# ----------------------------------------------------------------- detector
SIZE = 128


@pytest.fixture(scope="module")
def detectors():
    """The two packages' detectors with the same (randomised) weights.
    vis_thresh 0.05: random weights give scores near sigmoid(-2.19) ~ 0.10,
    so post-process, soft-NMS and PnP run on real (if meaningless) boxes."""
    _, variables = jax_model_and_variables("centerpose", size=SIZE, seed=2)
    jcfg = jax_preset("centerpose", input_h=SIZE, input_w=SIZE, vis_thresh=0.05)
    cfg = preset("centerpose", input_h=SIZE, input_w=SIZE, vis_thresh=0.05)
    ref = JaxDetector(jcfg, variables=variables)
    port = Detector(cfg, state_dict=from_jax_variables(variables), device="cpu")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (96, 128, 3)).astype(np.uint8) for _ in range(2)]
    return ref, port, images


def _assert_results_match(out, ref):
    assert set(out) >= {"results", "boxes", "meta"}
    assert len(out["results"]) == len(ref["results"]) > 0
    for o, r in zip(out["results"], ref["results"]):
        assert o["score"] == pytest.approx(r["score"], abs=1e-4)
        np.testing.assert_allclose(o["bbox"], r["bbox"], atol=0.05, rtol=0)
        np.testing.assert_allclose(o["kps"], r["kps"], atol=0.05, rtol=0)
        np.testing.assert_allclose(o["obj_scale"], r["obj_scale"], atol=1e-4, rtol=0)
        assert o["cls"] == r["cls"]
    for key in ("c", "s", "height", "width", "out_height", "out_width"):
        np.testing.assert_array_equal(out["meta"][key], ref["meta"][key])


def test_detector_run_matches_jax(detectors):
    ref, port, images = detectors
    out, exp = port.run(images[0]), ref.run(images[0])
    _assert_results_match(out, exp)
    assert set(out["times"]) == set(exp["times"])          # the stage `track` included
    # PnP ran on the survivors and its poses are finite.
    assert any("location" in d for d in out["results"])
    for d in out["results"]:
        if "location" in d:
            assert np.isfinite(d["location"]).all() and np.isfinite(d["quaternion_xyzw"]).all()


def test_detector_host_warp_path_matches_jax(detectors):
    """Multi-scale testing takes the host (numpy) warp and merges scales."""
    ref, port, images = detectors
    ref.cfg = ref.cfg.replace(test_scales=(1.0, 0.75))
    port.cfg = port.cfg.replace(test_scales=(1.0, 0.75))
    try:
        _assert_results_match(port.run(images[1]), ref.run(images[1]))
    finally:
        ref.cfg = ref.cfg.replace(test_scales=(1.0,))
        port.cfg = port.cfg.replace(test_scales=(1.0,))


def test_detector_run_batch_matches_jax(detectors):
    ref, port, images = detectors
    outs, exps = port.run_batch(images, timing=True), ref.run_batch(images, timing=True)
    assert len(outs) == len(exps) == 2
    for out, exp in zip(outs, exps):
        _assert_results_match(out, exp)
    assert set(outs[0]["times"]) == set(exps[0]["times"])
    streamed = list(port.run_batch_stream([(images[:1], None), (images[1:], None)]))
    assert [len(c) for c in streamed] == [1, 1]
    assert len(streamed[1][0]["results"]) == len(outs[1]["results"])


def test_detector_refuses_what_is_not_ported():
    # The dlav1 + tracking 4-step GRU model (an idea the reference never
    # tried), once refused, is served (`test_torch_port_gru_track.py`).
    det = Detector(preset("centerpose_track", arch="dlav1_34", input_h=64, input_w=64), device="cpu")
    assert det.model.convGRU.steps == 4 and det.tracker is not None
    with pytest.raises(ValueError):           # every arch of the JAX factory is ported
        Detector(preset("centerpose", arch="res_19", input_h=64, input_w=64), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(Exception):     # asked for "cuda" without one: no CPU fallback
            Detector(preset("centerpose_dla", input_h=64, input_w=64))


# ----------------------------------------------------------- import hygiene
def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_imports_no_jax():
    """Every module of the package, and chip_smoke.py, imports neither jax,
    flax nor the JAX package; and none imports triton or torchvision at
    module level (the tests here import every module)."""
    files = sorted((REPO / "centerpose_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    names = {p.relative_to(REPO).as_posix() for p in files}
    for module in ("tracking/kalman.py", "tracking/render.py", "tracking/tracker.py",
                   "tracking/tracker_baseline.py", "data/video.py", "demo.py",
                   "data/synthetic.py", "data/dataset.py", "data/loader.py", "data/tfrecord.py",
                   "utils/checkpoint.py", "utils/logger.py", "utils/tbevents.py", "train.py",
                   "models/resnet.py", "models/hourglass.py", "training/oracle.py",
                   "evaluation/metrics.py", "evaluation/iou3d.py", "evaluation/mobilepose.py",
                   "evaluation/relabel.py", "evaluation/evaluator.py", "data/objectron_pb.py",
                   "evaluate.py", "native/__init__.py", "utils/debugger.py", "utils/visualize.py",
                   "training/debug.py", "data/webcam.py", "scripts/__init__.py",
                   "scripts/probe_dcn_offsets.py", "scripts/accuracy_loop.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/step.py", "ops/psroi.py",
                   "geometry/collision.py", "utils/profiler.py", "scripts/group_report.py",
                   "scripts/batch_eval.py", "scripts/track_ablation.py", "scripts/ddp_scaling.py",
                   "bench.py", "graft_entry.py", "scripts/bench_e2e.py", "scripts/bench_train.py",
                   "utils/card.py", "geometry/__init__.py", "geometry/cuboid.py",
                   "scripts/make_synthetic_dataset.py", "scripts/synth_to_tfrecords.py",
                   "scripts/preprocess_tfrecords.py", "scripts/prepare_test_videos.py",
                   "scripts/preprocess_videos.py"):
        assert f"centerpose_tpu_torch/{module}" in names, module
    # The 3D IoU library is built from the package's own copy of the source.
    from centerpose_tpu_torch import native
    assert native.SOURCE == REPO / "centerpose_tpu_torch" / "native" / "iou3d.cpp"
    assert native.SOURCE.is_file() and native.library_path().parent == REPO / "centerpose_tpu_torch" / "build"
    banned = {"jax", "jaxlib", "flax", "centerpose_tpu", "optax", "orbax"}
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"
        tree = ast.parse(path.read_text())
        for node in tree.body:   # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(m.split(".")[0] in ("triton", "torchvision") for m in mods), path
