"""The PyTorch package's CenterPoseTrack video path against the JAX package's,
on the CPU: the tracking network (dla_34 with the previous-frame stems and the
tracking heads), a short video through both packages' `Detector`, the check
of the TPU kernel `_row_kernel` (B2) against the port's deformable
convolution, and the port's demo entry point.

Weights are made on the JAX side and carried across, as in
`test_torch_port_model.py`. For the video, the heatmap head's output conv is
scaled up so that scores spread far beyond float32 noise (random weights
otherwise give every cell ~sigmoid(-2.19) to within 1e-4, and the order of
near-ties differs between `torch.topk` and `jax.lax.top_k`), and the box
head's output bias is set so that boxes have the size of an object, which is
what lets detections of consecutive frames associate.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu.ops import dcn_onehot
from centerpose_tpu.ops.dcn import dcn_v2 as jax_dcn_v2
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.inference.detector import DEFAULT_CAMERA, Detector
from centerpose_tpu_torch.models.convert import from_jax_variables, load_jax_variables
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops.dcn import dcn_v2

from test_torch_port_model import randomize_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64


def jax_track_model(size, seed):
    """The JAX tracking model and random variables for it. flax creates a
    stem only for an input it sees, so the tree's shapes come from an
    abstract init with the three previous-frame inputs (`jax.eval_shape`:
    a real init of this model takes half a minute on the CPU); every leaf is
    then drawn with numpy (kernels with variance 1/fan_in), and
    `randomize_variables` re-draws norm statistics, biases and offset convs."""
    cfg = jax_preset("centerpose_track", input_h=size, input_w=size, dcn_impl="gather")
    model = jax_create_model(cfg)
    z = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), z, pre_img=z,
        pre_hm=jnp.zeros((1, size, size, 1)), pre_hm_hp=jnp.zeros((1, size, size, 8)),
    ))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("kernel", "weight"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.full(leaf.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, randomize_variables(variables, seed)


@pytest.fixture(scope="module")
def track_model():
    return jax_track_model(SIZE, seed=3)


def _inputs(seed, size):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, size, size, 3).astype(np.float32)
    pre_img = rng.randn(1, size, size, 3).astype(np.float32)
    pre_hm = rng.rand(1, size, size, 1).astype(np.float32)
    pre_hm_hp = rng.rand(1, size, size, 8).astype(np.float32)
    return x, pre_img, pre_hm, pre_hm_hp


def test_tracking_network_matches_jax(track_model):
    """All 11 heads of the dla_34 tracking model at 64x64, batch 1, with
    non-zero previous-frame inputs, atol 2e-4."""
    model, variables = track_model
    sd = from_jax_variables(variables)
    for stem in ("pre_img_layer", "pre_hm_layer", "pre_hm_hp_layer"):
        assert f"base.{stem}.0.weight" in sd and f"base.{stem}.1.running_var" in sd
    assert "tracking.2.weight" in sd and "tracking_hp.2.weight" in sd
    cfg = preset("centerpose_track", input_h=SIZE, input_w=SIZE)
    port = create_model(cfg, device="cpu")
    load_jax_variables(port, variables)
    args = _inputs(0, SIZE)
    ref = model.apply(variables, *[jnp.asarray(a) for a in args[:1]],
                      pre_img=jnp.asarray(args[1]), pre_hm=jnp.asarray(args[2]),
                      pre_hm_hp=jnp.asarray(args[3]))
    with torch.no_grad():
        out = port(*[torch.from_numpy(a) for a in args])
        without = port(torch.from_numpy(args[0]))
    assert list(out) == list(cfg.heads) and len(out) == 11 and set(out) == set(ref)
    for head in out:
        o, r = out[head].numpy(), np.asarray(ref[head])
        assert o.shape == r.shape == (1, SIZE // 4, SIZE // 4, cfg.heads[head])
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=0, err_msg=head)
    # The stems are live: without the previous frame the output differs.
    assert (out["hm"] - without["hm"]).abs().max() > 1e-5


def test_dlav1_tracking_routing_is_not_ported():
    """Ported now: in the dlav1 tracking model step 0 of the 4-step GRU feeds
    `tracking` / `tracking_hp` and step 1 the center heads."""
    model = create_model(preset("centerpose_track", arch="dlav1_34", input_h=SIZE, input_w=SIZE),
                         device="cpu")
    states, seen = [], {}
    model.convGRU.register_forward_hook(lambda m, i, o: states.extend(o))
    for head in ("tracking", "tracking_hp", "hm"):
        getattr(model, head).register_forward_hook(lambda m, i, o, head=head: seen.__setitem__(head, i[0]))
    with torch.no_grad():
        model(*[torch.from_numpy(a) for a in _inputs(1, SIZE)])
    assert len(states) == 4
    assert seen["tracking"] is states[0] and seen["tracking_hp"] is states[0] and seen["hm"] is states[1]


# -------------------------------------------------------------------- video
def _video(n=4, seed=5):
    """n frames of 96x128: one smooth seeded image moved a few pixels a frame."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (14, 18, 3)).astype(np.uint8)
    base = np.asarray(Image.fromarray(base).resize((144, 112), Image.BILINEAR))
    return [np.ascontiguousarray(base[2 * i:2 * i + 96, 3 * i:3 * i + 128]) for i in range(n)]


def _video_variables(track_model):
    """The tracking model's variables with five heads set so that a random
    network gives a coherent, tie-free video: heatmap logits spread (x40) and
    centred so the top ones sit near 0.5; boxes of 6 output pixels; no
    keypoint-heatmap peak above `hm_hp_thresh` (so PnP reads the displacement
    keypoints alone); displacement keypoints near the projection of a unit
    cube 14 units in front of the default camera, and a near-unit scale, so
    that every PnP solve is well posed."""
    variables = jax.tree_util.tree_map(np.array, track_model[1])   # a copy
    params = variables["params"]
    params["hm"]["out"]["kernel"] = params["hm"]["out"]["kernel"] * 40.0
    params["hm"]["out"]["bias"] = params["hm"]["out"]["bias"] - 4.0
    params["wh"]["out"]["bias"] = np.full_like(params["wh"]["out"]["bias"], 6.0)
    params["hm_hp"]["out"]["bias"] = np.full_like(params["hm_hp"]["out"]["bias"], -6.0)
    yaw = np.array([[np.cos(0.5), 0, np.sin(0.5)], [0, 1, 0], [-np.sin(0.5), 0, np.cos(0.5)]])
    corners = cuboid_vertices(np.ones(3)) @ yaw.T + [0.0, 0.0, 14.0]
    f_out = DEFAULT_CAMERA[0, 0] / (2 * 4)     # image pixels per output pixel: 128 / 64 * 4
    offsets = (corners[:, :2] / corners[:, 2:] * f_out).reshape(-1)
    params["hps"]["out"]["kernel"] = params["hps"]["out"]["kernel"] * 0.05
    params["hps"]["out"]["bias"] = offsets.astype(np.float32)
    params["scale"]["out"]["kernel"] = params["scale"]["out"]["kernel"] * 0.1
    params["scale"]["out"]["bias"] = np.ones(3, np.float32)
    return variables


VIDEO_THRESH = dict(vis_thresh=0.3, new_thresh=0.3)


def test_video_matches_jax(track_model):
    """Four frames through both detectors (the first on the host-warp path,
    the rest on the device path with the previous-frame render): per frame
    the same results in the same order with the same track ids; scores 1e-4,
    boxes, keypoints and fused keypoints 0.05 px, locations and quaternions
    1e-3 (a float32 PnP on either side, as in `test_torch_port_serving.py`;
    the readings are about 1e-5)."""
    variables = _video_variables(track_model)
    kw = dict(input_h=SIZE, input_w=SIZE, category="shoe", **VIDEO_THRESH)
    ref = JaxDetector(jax_preset("centerpose_track", dcn_impl="gather", **kw), variables=variables)
    port = Detector(preset("centerpose_track", **kw), state_dict=from_jax_variables(variables),
                    device="cpu")
    n_tracked = 0
    ids_seen = []
    for f, frame in enumerate(_video()):
        exp, out = ref.run(frame), port.run(frame)
        assert set(out["times"]) == set(exp["times"])
        assert len(out["results"]) == len(exp["results"]) > 0, f
        assert len(out["boxes"]) == len(exp["boxes"]), f
        # Discrete decisions with a margin: scores are apart from each other
        # and from the thresholds by more than the packages' difference.
        scores = sorted(d["score"] for d in exp["results"] if d.get("age", 1) == 1)
        assert all(abs(s - 0.3) > 1e-4 for s in scores)
        assert all(b - a > 1e-4 for a, b in zip(scores, scores[1:]))
        for o, r in zip(out["results"], exp["results"]):
            assert o["tracking_id"] == r["tracking_id"] and o["age"] == r["age"], f
            assert o["score"] == pytest.approx(r["score"], abs=1e-4)
            for key in ("bbox", "kps", "kps_fusion_mean"):
                np.testing.assert_allclose(o[key], r[key], atol=0.05, rtol=0, err_msg=key)
            assert ("location" in o) == ("location" in r)
            if "location" in o:
                n_tracked += 1
                np.testing.assert_allclose(o["location"], r["location"], atol=1e-3, rtol=0)
                np.testing.assert_allclose(o["quaternion_xyzw"], r["quaternion_xyzw"], atol=1e-3, rtol=0)
        ids_seen.append([d["tracking_id"] for d in out["results"]])
        if f == 0:
            assert port.pre_images is not None
    assert n_tracked > 0
    # Some id is carried from frame to frame, and the previous frame fed the net.
    assert set(ids_seen[0]) & set(ids_seen[-1])
    port.reset_tracking()
    assert port.pre_images is None and port.tracker.tracks == []


def test_refined_kalman_runs_the_baseline_tracker():
    from centerpose_tpu_torch.tracking.tracker_baseline import TrackerBaseline

    det = Detector(preset("centerpose_dla", input_h=SIZE, input_w=SIZE, refined_kalman=True,
                          vis_thresh=0.05, new_thresh=0.05), device="cpu")
    assert isinstance(det.tracker, TrackerBaseline)
    frames = _video(2)
    outs = [det.run(frame) for frame in frames]
    assert all("track" in o["times"] for o in outs)
    assert any("tracking_id" in d for d in outs[-1]["results"])
    # Setting the detector's config reaches the tracker.
    det.cfg = det.cfg.replace(max_age=7)
    assert det.tracker.cfg.max_age == 7


# ------------------------------------------------------------------ B2 check
def _b2_case(seed, radius, far_dy=None):
    """Operands with every |dy| <= radius, samples pushed across all four
    borders, and optionally the centre tap moved `far_dy` rows down."""
    rng = np.random.RandomState(seed)
    b, h, w, c, co = 2, 7, 8, 16, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = ((rng.rand(b, h, w, 18) * 2 - 1) * radius).astype(np.float32)
    off[:, :2, :, 0::2] = -radius                       # rows pushed across the top border
    off[:, -2:, :, 0::2] = radius                       # and the bottom one
    off[:, :, :2, 1::2] = -2.5
    off[:, :, -2:, 1::2] = 2.5
    if far_dy is not None:
        off[..., 8] = far_dy                            # tap 4 (the centre), |dy| > 2
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    wt = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    return [x, off, mask, wt, bias]


def _row_window_mask(mask, off, radius):
    """`mask` with the taps zeroed that `_row_kernel` drops: with one row per
    program (G=1 at H=7) the window is rows [r0, r0+rw), rw = min(2R+3, H),
    r0 = clip(h-1-R, 0, H-rw) (dcn_onehot.py:101-104). Integer dy only."""
    b, h, w, _ = mask.shape
    rw = min(2 * radius + 3, h)
    out = mask.copy()
    for hh in range(h):
        r0 = min(max(hh - 1 - radius, 0), h - rw)
        for t in range(9):
            y0 = np.floor(hh - 1 + t // 3 + off[:, hh, :, 2 * t])
            out[:, hh, :, t] = np.where((y0 >= r0) & (y0 < r0 + rw), out[:, hh, :, t], 0.0)
    return out


@pytest.mark.parametrize("case", ["within_radius", "far_dy_window_spans_image", "far_dy_dropped"])
def test_port_dcn_against_row_kernel(case):
    """The port's DCN (`dcn_v2`, which the CUDA kernel `csrc/dcn_v2_fwd.cu`
    is held against on the card) against the TPU kernel `_row_kernel` (B2,
    `dcn_v2_onehot(exact=True)`, interpret mode) at B=2, H=7, W=8, C=16, Co=8.

    Where every |dy| <= radius (2), borders included, they agree at 2e-5.
    They diverge by design where |dy| > radius: B2 samples only a window of
    2R+3 rows around each output row (a VMEM limit of the TPU) and a tap
    outside it contributes 0, while the port samples every offset, as the
    JAX package's exact `dcn_v2` does. With R=2 at H=7 that window is the
    whole image, so B2 still equals the exact op (the kernel's own comment,
    dcn_onehot.py:101-102); with R=1 (window 5 rows) a centre tap 4 rows down
    is dropped where it falls outside the window, and B2 then equals the exact
    op with those taps' masks set to 0."""
    far = None if case == "within_radius" else 4.0
    radius = 1 if case == "far_dy_dropped" else 2
    args = _b2_case(7, radius, far)
    jargs = [jnp.asarray(a) for a in args]
    b2 = np.asarray(dcn_onehot.dcn_v2_onehot(*jargs, radius, True))
    exact = np.asarray(jax_dcn_v2(*jargs))
    port = dcn_v2(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(port, exact, atol=2e-5, rtol=1e-5)
    if case == "far_dy_dropped":
        dropped = _row_window_mask(args[2], args[1], radius)
        assert (dropped == 0).sum() > 0
        assert np.abs(b2 - port).max() > 1e-2              # B2 drops taps the port samples
        windowed = np.asarray(jax_dcn_v2(jargs[0], jargs[1], jnp.asarray(dropped), *jargs[3:]))
        np.testing.assert_allclose(b2, windowed, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(port, b2, atol=2e-5, rtol=1e-5)


# --------------------------------------------------------------------- demo
def test_demo_tracking_writes_track_ids(tmp_path):
    """`python -m centerpose_tpu_torch.demo --device cpu --tracking` over a
    folder of three frames: one JSON per frame, with track ids. The weights
    come through `--load_model` (a state dict whose heatmap bias puts the
    scores above the thresholds)."""
    from PIL import Image

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, frame in enumerate(_video(3)):
        Image.fromarray(frame).save(frames_dir / f"{i:05d}.png")
    model = create_model(preset("centerpose_track", input_h=128, input_w=128), device="cpu")
    sd = model.state_dict()
    sd["hm.2.bias"].fill_(1.0)
    sd["wh.2.bias"].fill_(8.0)
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in sd.items()}},
               tmp_path / "model.pth")
    out_dir = tmp_path / "out"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "centerpose_tpu_torch.demo", "--device", "cpu", "--tracking",
         "--input_res", "128", "--demo", str(frames_dir), "--out_dir", str(out_dir),
         "--load_model", str(tmp_path / "model.pth"), "--dcn_impl", "onehot_exact"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = sorted(out_dir.glob("*.json"))
    assert [f.name for f in files] == [f"frame_{i:05d}.json" for i in range(3)]
    for f in files:
        rec = json.loads(f.read_text())
        assert set(rec["times"]) >= {"pre", "net", "merge", "pnp", "track", "tot"}
        assert rec["detections"] and all("tracking_id" in d for d in rec["detections"])
    assert "track" in proc.stdout


def test_demo_resdcn_18_on_one_image(tmp_path):
    """`demo.main(--arch resdcn_18 --device cpu --input_res 128)` on one
    image with `--load_model` a reference-style checkpoint (`{epoch,
    state_dict}`, `module.` prefixes; the heatmap bias raised so that random
    weights detect): one JSON with detections and the stage times."""
    from PIL import Image

    from centerpose_tpu_torch import demo

    Image.fromarray(_video(1)[0]).save(tmp_path / "img.png")
    cfg = preset("centerpose_dla", arch="resdcn_18", input_h=128, input_w=128)
    sd = create_model(cfg, device="cpu").state_dict()
    sd["hm.2.bias"].fill_(1.0)
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in sd.items()}}, tmp_path / "m.pth")
    assert demo.main(["--device", "cpu", "--arch", "resdcn_18", "--input_res", "128",
                      "--demo", str(tmp_path / "img.png"), "--out_dir", str(tmp_path / "out"),
                      "--load_model", str(tmp_path / "m.pth")]) == 0
    rec = json.loads((tmp_path / "out" / "img.json").read_text())
    assert rec["detections"] and set(rec["times"]) >= {"pre", "net", "pnp", "tot"}
