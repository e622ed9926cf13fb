"""The PyTorch package's dlav1 + tracking model (the 4-step convGRU routing)
against the JAX package's, on the CPU.

`preset("centerpose_track", arch="dlav1_34")`: the DLA-34 trunk with the
previous-frame stems, the DCN neck, a 4-step ConvGRU whose step 0 feeds
`tracking` / `tracking_hp` and steps 1-3 the image heads, and 11 GroupNorm
heads. `preset("centerpose", tracking_task=True)` has no tracking heads:
its image heads still read steps 1-3 (the JAX loop keeps the step index of
a group with no head present). Weights are drawn on the JAX side (shapes
from `jax.eval_shape`, as in `test_torch_port_video.py`) and carried
across; the JAX side runs its exact gather DCN. The model is served through
both packages' `Detector` (one frame a call, the tracker), and the port's
trainer takes a step on a batch of its tracking dataset.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import dataset
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.convert import from_jax_variables, load_jax_variables, to_jax_tree
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training import trainer

from test_torch_port_model import randomize_variables
from test_torch_port_resnet import release_memory
from test_torch_port_video import VIDEO_THRESH, _video, _video_variables

SIZE = 64
TRACK_V1 = ("centerpose_track", {"arch": "dlav1_34"})
NO_TRACK_HEADS = ("centerpose", {"tracking_task": True})
STEMS = ("base.pre_img_layer.", "base.pre_hm_layer.", "base.pre_hm_hp_layer.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


def jax_model(name, over, seed):
    """The JAX model of `preset(name, **over)` at SIZE and random variables:
    shapes from an abstract init with the three previous-frame inputs,
    kernels drawn with variance 1/fan_in, then `randomize_variables`."""
    cfg = jax_preset(name, input_h=SIZE, input_w=SIZE, dcn_impl="gather", **over)
    model = jax_create_model(cfg)
    z = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), z, pre_img=z,
        pre_hm=jnp.zeros((1, SIZE, SIZE, 1)), pre_hm_hp=jnp.zeros((1, SIZE, SIZE, 8))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key in ("kernel", "weight"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.full(leaf.shape, 1.0 if path[-1].key in ("scale", "var") else 0.0, np.float32)

    return model, randomize_variables(jax.tree_util.tree_map_with_path(draw, shapes), seed)


@pytest.fixture(scope="module")
def track_v1():
    return jax_model(*TRACK_V1, seed=3)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, SIZE, SIZE, 3).astype(np.float32), rng.randn(2, SIZE, SIZE, 3).astype(np.float32),
            rng.rand(2, SIZE, SIZE, 1).astype(np.float32), rng.rand(2, SIZE, SIZE, 8).astype(np.float32))


@pytest.mark.parametrize("which", [TRACK_V1, NO_TRACK_HEADS], ids=["track_dlav1", "no_tracking_heads"])
def test_four_step_model_matches_jax(which, track_v1):
    """Every head within 2e-4 at 64x64, batch 2, the previous-frame inputs
    non-zero, DCN offsets perturbed; the weights round-trip through
    `to_jax_tree` unchanged."""
    name, over = which
    model, variables = track_v1 if which is TRACK_V1 else jax_model(name, over, seed=4)
    cfg = preset(name, input_h=SIZE, input_w=SIZE, **over)
    assert cfg.use_conv_gru and cfg.gru_steps == 4
    port = create_model(cfg, device="cpu")
    assert port.convGRU.steps == 4
    load_jax_variables(port, variables)
    x, pre_img, pre_hm, pre_hm_hp = _inputs(0)
    ref = model.apply(variables, jnp.asarray(x), pre_img=jnp.asarray(pre_img),
                      pre_hm=jnp.asarray(pre_hm), pre_hm_hp=jnp.asarray(pre_hm_hp))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (x, pre_img, pre_hm, pre_hm_hp)))
    assert list(out) == list(cfg.heads) and set(out) == set(ref)
    assert ("tracking" in out) == (which is TRACK_V1)
    for head in out:
        o, r = out[head].numpy(), np.asarray(ref[head])
        assert o.shape == r.shape == (2, SIZE // 4, SIZE // 4, cfg.heads[head])
        assert np.abs(r).max() > 1e-2, head
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=0, err_msg=head)
    back = to_jax_tree(port.state_dict(), variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("which", [TRACK_V1, NO_TRACK_HEADS], ids=["track_dlav1", "no_tracking_heads"])
def test_gru_step_routing(which):
    """Step 0 feeds `tracking` / `tracking_hp`, steps 1-3 the image groups,
    also where the tracking heads are absent (steps 1-3, not 0-2)."""
    name, over = which
    model = create_model(preset(name, input_h=SIZE, input_w=SIZE, **over), device="cpu")
    seen, states = {}, []
    model.convGRU.register_forward_hook(lambda m, i, o: states.extend(o))
    for head in model.head_names:
        getattr(model, head).register_forward_hook(
            lambda m, i, o, head=head: seen.__setitem__(head, i[0]))
    with torch.no_grad():
        model(*(torch.from_numpy(a) for a in _inputs(1)))
    assert len(states) == 4
    step = {"tracking": 0, "tracking_hp": 0, "hm": 1, "wh": 1, "reg": 1, "hm_hp": 2, "hps": 2,
            "hp_offset": 2, "hps_uncertainty": 2, "scale": 3, "scale_uncertainty": 3}
    assert set(seen) == set(model.head_names)
    for head, feature in seen.items():
        assert feature is states[step[head]], head


def test_video_through_both_detectors(track_v1):
    """Four frames of one video through both packages' `Detector` (the
    tracker, the previous frame and its rendered heatmaps fed back): per
    frame the same results in the same order with the same track ids,
    scores 1e-4, boxes and keypoints 0.05 px, poses 1e-3."""
    variables = _video_variables(track_v1)
    kw = dict(input_h=SIZE, input_w=SIZE, category="shoe", **VIDEO_THRESH, **TRACK_V1[1])
    ref = JaxDetector(jax_preset(TRACK_V1[0], dcn_impl="gather", **kw), variables=variables)
    port = Detector(preset(TRACK_V1[0], **kw), state_dict=from_jax_variables(variables), device="cpu")
    assert port.model.convGRU.steps == 4
    n_results, ids = 0, []
    for f, frame in enumerate(_video()):
        exp, out = ref.run(frame), port.run(frame)
        assert len(out["results"]) == len(exp["results"]), f
        for o, r in zip(out["results"], exp["results"]):
            assert o["tracking_id"] == r["tracking_id"] and o["age"] == r["age"], f
            assert o["score"] == pytest.approx(r["score"], abs=1e-4)
            for key in ("bbox", "kps"):
                np.testing.assert_allclose(o[key], r[key], atol=0.05, rtol=0, err_msg=key)
            assert ("location" in o) == ("location" in r)
            if "location" in o:
                np.testing.assert_allclose(o["location"], r["location"], atol=1e-3, rtol=0)
        n_results += len(out["results"])
        ids.append({d["tracking_id"] for d in out["results"]})
    assert n_results > 0 and port.pre_images is not None
    assert ids[0] & ids[-1]                 # a track carried through the video


def test_train_step_trains_it(tmp_path):
    """The trainer's tracking step on a batch of 2 from the port's tracking
    dataset: finite losses, the tracking losses live, a gradient into the
    stems, the GRU and both tracking heads, and every such parameter moved."""
    generate_dataset(str(tmp_path), n_videos=2, frames_per_video=3, seed=4, width=160, height=120)
    cfg = preset(TRACK_V1[0], input_h=SIZE, input_w=SIZE, batch_size=2, **TRACK_V1[1])
    ds = dataset.ObjectPoseDataset(str(tmp_path), cfg, split="train", seed=2, compact_wire=True)
    items = [ds[i] for i in (1, 4)]
    for item in items:
        item.pop("meta")
    batch = dataset.collate_filtered(items)
    assert batch["tracking_mask"].sum() > 0
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    state, tx = trainer.create_train_state(cfg, model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    state, stats = trainer.make_train_step(cfg, model, tx)(state, batch)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in stats.values())
    assert float(stats["tracking_loss"]) > 0 and float(stats["tracking_hp_loss"]) > 0
    for name, p in model.named_parameters():
        if name.startswith(STEMS + ("convGRU.", "tracking.", "tracking_hp.")) and name.endswith("weight"):
            assert float(p.grad.abs().max()) > 0, name
            assert not torch.equal(p.detach(), before[name]), name
