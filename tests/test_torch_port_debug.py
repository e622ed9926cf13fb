"""The PyTorch package's debug canvases against the JAX package's, on the CPU:
the `Debugger` primitives and the `visualize` renders pixel for pixel, the
train-time canvases (`training/debug.py::render_train_debug`) on the same
batch and head maps, and `Detector.render_debug` with the same weights.

One module-scoped JAX model (dlav1_34 at 64x64, variables from
`jax.eval_shape`, kernels drawn, norm statistics, biases and offset convs
re-drawn), one intra-op thread, and the file's memory handed back at its end.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu.training import debug as jax_debug
from centerpose_tpu.training.trainer import decode_wire_np as jax_decode_wire_np
from centerpose_tpu.utils import debugger as jax_debugger
from centerpose_tpu.utils import visualize as jax_visualize
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets, stack_batch
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.convert import from_jax_variables
from centerpose_tpu_torch.training import debug
from centerpose_tpu_torch.training.trainer import decode_wire_np
from centerpose_tpu_torch.utils import debugger, visualize

from test_torch_port_resnet import jax_model_and_variables, release_memory

SIZE = 64
K = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


@pytest.fixture(scope="module")
def flagship():
    """The JAX dlav1_34 at 64x64 (K = 8, every detection shown) and its
    random variables."""
    cfg = jax_preset("centerpose", input_h=SIZE, input_w=SIZE, dcn_impl="gather", K=K,
                     vis_thresh=0.0)
    return jax_model_and_variables(cfg, seed=3) + (cfg,)


# ---------------------------------------------------------------- primitives
def _canvas(seed, h=48, w=64):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _cuboid_points(rng, n=8, lo=-10, hi=70):
    pts = rng.uniform(lo, hi, (n, 2))
    pts[rng.rand(n) < 0.2] = -10000.0                  # the reference's "not visible" sentinel
    return pts


DRAWS = {
    "add_img": lambda d, rng: d.add_img(_canvas(1), "c", revert_color=True),
    "add_blend_img": lambda d, rng: d.add_blend_img(_canvas(1), rng.rand(12, 16, 3) * 255, "c", 0.4),
    "add_blend_img_gray": lambda d, rng: d.add_blend_img(_canvas(1), rng.rand(48, 64) * 255, "c"),
    "add_coco_bbox": lambda d, rng: d.add_coco_bbox(rng.uniform(-5, 60, 4), 0, 0.4375, img_id="c"),
    "add_coco_bbox_plain": lambda d, rng: d.add_coco_bbox([3, 4, 50, 40], 0, 1.0, show_txt=False,
                                                          img_id="c"),
    "add_coco_hp_pred": lambda d, rng: d.add_coco_hp(_cuboid_points(rng), img_id="c"),
    "add_coco_hp_gt": lambda d, rng: d.add_coco_hp(_cuboid_points(rng), img_id="c", pred_flag="gt"),
    "add_coco_hp_pnp": lambda d, rng: d.add_coco_hp(_cuboid_points(rng), img_id="c", pred_flag="pnp"),
    "add_coco_hp_extra": lambda d, rng: d.add_coco_hp(_cuboid_points(rng), img_id="c",
                                                      pred_flag="extra"),
    "add_obj_scale_pred": lambda d, rng: d.add_obj_scale([5, 5, 60, 40], rng.rand(3), img_id="c"),
    "add_obj_scale_gt": lambda d, rng: d.add_obj_scale([-3, 30, 40, 47], rng.rand(3), img_id="c",
                                                       pred_flag="gt"),
    "add_arrow": lambda d, rng: d.add_arrow(rng.uniform(0, 60, 2), rng.uniform(-20, 20, 2), "c"),
    "add_arrow_zero": lambda d, rng: d.add_arrow([30, 20], [0, 0], "c", c=(255, 255, 0)),
    "add_axes": lambda d, rng: d.add_axes(
        np.array([[0, 0, 1]] + [[x, y, 1 + z] for x in (-0.1, 0.1) for y in (-0.1, 0.1)
                                for z in (-0.1, 0.1)]) + rng.uniform(-0.02, 0.02, (9, 3)),
        np.array([[120.0, 0, 32], [0, 120.0, 24], [0, 0, 1]]), img_id="c"),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_debugger_primitive_matches_jax(name):
    """Each `Debugger` drawing call, on the same canvas and the same numpy
    inputs, gives the JAX package's canvas to the byte."""
    canvases = []
    for mod in (jax_debugger, debugger):
        dbg = mod.Debugger(theme="white" if "blend" in name else "black")
        dbg.add_img(_canvas(0), "c")
        DRAWS[name](dbg, np.random.RandomState(sorted(DRAWS).index(name)))
        canvases.append(dbg.imgs["c"])
    assert canvases[0].dtype == canvases[1].dtype == np.uint8
    np.testing.assert_array_equal(canvases[1], canvases[0])


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("output_res", [None, (48, 64)])
def test_debugger_colormaps_match_jax(hp, output_res):
    rng = np.random.RandomState(7)
    hm = rng.uniform(-0.2, 1.2, (12, 16, 8 if hp else 1)).astype(np.float32)
    maps = []
    for mod in (jax_debugger, debugger):
        dbg = mod.Debugger(down_ratio=4)
        maps.append(dbg.gen_colormap_hp(hm, output_res) if hp
                    else dbg.gen_colormap(hm[..., 0], output_res, color=(10, 200, 30)))
    assert maps[1].shape == (48, 64, 3)
    np.testing.assert_array_equal(maps[1], maps[0])


def test_draw_text_and_save_match_jax(tmp_path):
    texts = []
    for mod in (jax_debugger, debugger):
        img = _canvas(2)
        mod._draw_text(img, "Pred:0.123/4.5-6 x?", (-3, 40), color=(9, 8, 7), scale=3)
        texts.append(img)
    np.testing.assert_array_equal(texts[1], texts[0])
    dbg = debugger.Debugger()
    dbg.add_img(texts[1], "a")
    dbg.save_all_imgs(str(tmp_path), prefix="x_")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["x_a.png"]


def _results(rng, n=3):
    out = []
    for i in range(n):
        x0, y0 = rng.uniform(-10, 50, 2)
        out.append({"bbox": [x0, y0, x0 + rng.uniform(5, 40), y0 + rng.uniform(5, 40)],
                    "kps": rng.uniform(-10, 70, 16), "ct": rng.uniform(0, 60, 2),
                    **({"tracking": rng.uniform(-15, 15, 2)} if i != 1 else {})})
    return out


VISUALS = {
    "draw_detections": lambda m, img, rng: m.draw_detections(
        img, _results(rng), [(np.c_[rng.uniform(-0.1, 1.1, (9, 1)), rng.uniform(-0.1, 1.1, (9, 1))],)
                             for _ in range(2)]),
    "overlay_heatmap": lambda m, img, rng: m.overlay_heatmap(img, rng.rand(12, 16), alpha=0.7),
    "overlay_heatmap_joints": lambda m, img, rng: m.overlay_heatmap(img, rng.rand(48, 64, 8)),
    "draw_tracking_arrows": lambda m, img, rng: m.draw_tracking_arrows(img, _results(rng)),
    "draw_axes": lambda m, img, rng: m.draw_axes(
        img, np.linalg.qr(rng.randn(3, 3))[0], np.array([0.05, -0.02, -1.0]),
        np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]]), length=0.2),
}


@pytest.mark.parametrize("name", sorted(VISUALS))
def test_visualize_matches_jax(name):
    outs = [VISUALS[name](mod, _canvas(3), np.random.RandomState(5))
            for mod in (jax_visualize, visualize)]
    assert outs[1].dtype == np.uint8 and outs[1].shape == (48, 64, 3)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_draw_line_is_the_jax_loop():
    """The port's line drawer writes each square offset at once; the JAX
    package's loops over the points: the same pixels, across thicknesses,
    lines leaving the image, half-pixel ends and zero length."""
    rng = np.random.RandomState(11)
    for i in range(300):
        h, w = rng.randint(5, 60, 2)
        p0, p1 = rng.uniform(-30, 90, 2), rng.uniform(-30, 90, 2)
        if i % 5 == 0:
            p0, p1 = np.round(p0) + 0.5, np.round(p1) - 0.5
        if i % 7 == 0:
            p1 = p0.copy()
        thickness = int(rng.randint(1, 6))
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        jax_visualize._draw_line(a, p0, p1, (1, 2, 3), thickness)
        visualize._draw_line(b, p0, p1, (1, 2, 3), thickness)
        np.testing.assert_array_equal(b, a, err_msg=f"{p0} {p1} {thickness}")


# ------------------------------------------------------------- train canvases
# Pixels may differ only where a decoded point lands within float32 rounding
# of a half pixel and rounds to the neighbouring pixel in the other package.
TRAIN_PIXELS_OFF = 0.005


def test_render_train_debug_matches_jax(flagship, tmp_path):
    """One wire-encoded batch of 2 at 64x64 with its targets and the JAX
    network's head maps on it, through both packages' `render_train_debug`
    (every detection drawn): the same canvases and sizes, pixels equal but
    for a share of at most TRAIN_PIXELS_OFF per canvas."""
    model, variables, jcfg = flagship
    cfg = preset("centerpose", input_h=SIZE, input_w=SIZE, K=K)
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(2):
        obj = ObjectAnnotation(center=np.array([8.0, 8.0]), size=np.array([8.0, 8.0]),
                               keypoints=rng.uniform(2, 14, size=(1, 8, 2)).astype(np.float32),
                               keypoints_visible=np.ones((1, 8), bool),
                               scale_3d=np.array([1.0, 0.5, 0.8], np.float32))
        samples.append(render_targets([obj], cfg))
    batch = stack_batch(samples)
    batch["input"] = rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    batch["hm"] = (np.clip(batch["hm"], 0, 1) * 255).astype(np.uint8)   # the compact wire
    decoded = decode_wire_np(batch)
    ref_decoded = jax_decode_wire_np(batch)
    for key in ref_decoded:
        np.testing.assert_array_equal(decoded[key], ref_decoded[key], err_msg=key)
    outputs = jax.jit(model.apply)(variables, jnp.asarray(decoded["input"]))
    outputs = {k: np.asarray(v) for k, v in outputs.items()}

    ref = jax_debug.render_train_debug(ref_decoded, outputs, jcfg, center_thresh=-1.0)
    got = debug.render_train_debug(decoded, outputs, cfg, center_thresh=-1.0)
    assert sorted(got) == sorted(ref) == sorted(
        ("out_hm_pred", "out_hm_gt", "out_hmhp_pred", "out_hmhp_gt", "out_img_pred", "out_img_gt",
         "out_pred_gt_blend"))
    for name in ref:
        assert got[name].shape == ref[name].shape == (SIZE, SIZE, 3) and got[name].dtype == np.uint8
        off = (got[name] != ref[name]).any(axis=-1).mean()
        assert off <= TRAIN_PIXELS_OFF, f"{name}: {off:.4f} of the pixels differ"
    assert (got["out_img_gt"] != got["out_hm_gt"]).any()      # the GT wireframes were drawn
    debug.save_train_debug(got, str(tmp_path), "e1_")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"e1_{n}.png" for n in ref)


# ---------------------------------------------------------- detector canvases
def test_detector_render_debug_matches_jax(flagship):
    """`debug_level = 2`: both detectors take the host warp and keep the raw
    maps; `render_debug` gives the JAX canvas set, each of its size, and the
    canvases over the network input agree but for TRAIN_PIXELS_OFF of their
    pixels. The image-space canvas carries the PnP cuboids, which on random
    weights are ill-posed (ROADMAP.md §C), so only its size is held."""
    _, variables, jcfg = flagship
    cfg = preset("centerpose", input_h=SIZE, input_w=SIZE, K=K, vis_thresh=0.0)
    ref_det = JaxDetector(jcfg, variables=variables)
    det = Detector(cfg, state_dict=from_jax_variables(variables), device="cpu")
    ref_det.debug_level = det.debug_level = 2
    img = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    ref = ref_det.render_debug(img, ref_det.run(img)).imgs
    out = det.run(img)
    got = det.render_debug(img, out).imgs
    assert sorted(got) == sorted(ref)
    assert {"out_hm_pred", "out_hmhp_pred", "out_kps_processed_pred", "out_img_pred"} <= set(got)
    for name in ref:
        assert got[name].shape == ref[name].shape and got[name].dtype == np.uint8, name
        if name != "out_img_pred":      # PnP poses on random weights are ill-posed: not compared
            off = (got[name] != ref[name]).any(axis=-1).mean()
            assert off <= TRAIN_PIXELS_OFF, f"{name}: {off:.4f} of the pixels differ"
    assert got["out_img_pred"].shape == img.shape
    assert got["out_hm_pred"].shape == (SIZE, SIZE, 3)
    # The device-warp path stays the default: no raw maps are kept there.
    det2 = Detector(cfg, state_dict=from_jax_variables(variables), device="cpu")
    det2.run(img)
    assert det2._debug_raw is None
    assert sorted(det2.render_debug(img, out).imgs) == ["out_img_pred"]
