"""The PyTorch package's network against the JAX package's, on the CPU.

Weights are made on the JAX side (its own init, then every BatchNorm / GroupNorm
statistic, every bias and every DCN offset conv re-drawn with numpy from a
seed so that nothing is at its trivial initial value), carried across with
`centerpose_tpu_torch.models.convert`, and the same numpy input goes through
both. float32 throughout; the JAX side runs its exact gather DCN
(`dcn_impl="gather"`) and, by default, its fused heads / hoisted GRU
projections / space-to-depth stem, which are re-arrangements of the same sums:
module tolerances are 1e-5, the whole network's 2e-4 (the JAX package's own
bound for DCN architectures).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu.models import conv_gru as jax_gru
from centerpose_tpu.models import layers as jax_layers
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.models import conv_gru, layers
from centerpose_tpu_torch.models.convert import (
    _t_conv,
    from_jax_variables,
    load_jax_variables,
)
from centerpose_tpu_torch.models.factory import create_model

SIZE = 64  # input side of the whole-network tests


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), dict(tree))


def randomize_variables(variables, seed=0):
    """numpy copy of a flax variables tree with norm statistics, biases and DCN
    offset convs re-drawn (conv kernels keep the JAX init's scale, so that
    activations stay O(1) through the depth of the network)."""
    rng = np.random.RandomState(seed)
    tree = to_numpy_tree(variables)

    def walk(node, path):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            shape = val.shape
            if "conv_offset_mask" in path:
                fan_in = int(np.prod(shape[:-1])) if key == "kernel" else 1
                std = 0.5 / np.sqrt(fan_in) if key == "kernel" else 0.5
                node[key] = (rng.randn(*shape) * std).astype(np.float32)
            elif key in ("scale", "var"):
                node[key] = rng.uniform(0.6, 1.4, shape).astype(np.float32)
            elif key == "mean" or (key == "bias" and path and path[-1] in ("bn", "gn")):
                node[key] = (rng.randn(*shape) * 0.1).astype(np.float32)
            elif key == "bias":
                node[key] = (val + rng.randn(*shape) * 0.05).astype(np.float32)

    for coll in tree.values():
        walk(coll, ())
    return tree


def jax_model_and_variables(preset_name, size=SIZE, seed=0, **overrides):
    cfg = jax_preset(preset_name, input_h=size, input_w=size,
                     dcn_impl="gather", **overrides)
    model = jax_create_model(cfg)
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3), jnp.float32)
    )
    return model, randomize_variables(variables, seed)


def n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def flagship():
    model, variables = jax_model_and_variables("centerpose")
    return model, variables


def test_convert_covers_every_leaf(flagship):
    _, variables = flagship
    sd = from_jax_variables(variables)
    tracked = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(sd) - len(tracked) == n_leaves(variables)
    port = create_model(preset("centerpose"), device="cpu")
    assert set(sd) == set(port.state_dict())
    load_jax_variables(port, variables)
    # Layouts: a 3x3 conv kernel HWIO -> OIHW, the DCN weight alike.
    k = variables["params"]["base"]["level2"]["tree1"]["conv1"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        port.state_dict()["base.level2.tree1.conv1.weight"].numpy(),
        np.transpose(k, (3, 2, 0, 1)),
    )
    assert _t_conv(k).shape == (k.shape[3], k.shape[2], 3, 3)


def test_convert_refuses_unmapped_and_mismatched_leaves(flagship):
    _, variables = flagship
    port = create_model(preset("centerpose"), device="cpu")
    extra = {c: dict(v) for c, v in variables.items()}
    extra["params"]["mystery"] = {"kernel": np.zeros((3, 3, 4, 4), np.float32)}
    with pytest.raises(KeyError):
        from_jax_variables(extra)
    # A leaf that maps to a name the model does not have.
    extra = {c: dict(v) for c, v in variables.items()}
    extra["params"]["tracking"] = variables["params"]["wh"]
    with pytest.raises(KeyError):
        load_jax_variables(port, extra)
    # A leaf of the wrong shape.
    bad = {c: dict(v) for c, v in variables.items()}
    bad["params"]["hm"] = {k: dict(v) for k, v in variables["params"]["hm"].items()}
    bad["params"]["hm"]["out"]["kernel"] = np.zeros((1, 1, 256, 5), np.float32)
    with pytest.raises(ValueError):
        load_jax_variables(port, bad)
    # A missing leaf.
    short = {c: dict(v) for c, v in variables.items()}
    short["params"] = {k: v for k, v in short["params"].items() if k != "scale"}
    with pytest.raises(KeyError):
        load_jax_variables(port, short)


def _nhwc(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )


def _assert_close(port_out_nchw, ref_nhwc, atol):
    out = port_out_nchw.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref_nhwc.shape
    np.testing.assert_allclose(out, np.asarray(ref_nhwc), atol=atol, rtol=0)


def test_deform_conv_block_matches_flax():
    """DCN + BN + ReLU with a randomised offset conv (a zero one would
    exercise no sampling). atol 1e-5: one f32 product of 9*16 terms."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 10, 16).astype(np.float32)
    mod = jax_layers.DeformConvBlock(24, dcn_impl="gather")
    variables = randomize_variables(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = mod.apply(variables, jnp.asarray(x))
    om = variables["params"]["conv_offset_mask"]["kernel"]
    assert np.abs(om).max() > 0

    port = layers.DeformConvBlock(16, 24).eval()
    p, bs = variables["params"], variables["batch_stats"]
    port.load_state_dict({
        "conv.weight": torch.from_numpy(_t_conv(p["weight"])),
        "conv.bias": torch.from_numpy(p["bias"]),
        "conv.conv_offset_mask.weight": torch.from_numpy(_t_conv(om)),
        "conv.conv_offset_mask.bias": torch.from_numpy(p["conv_offset_mask"]["bias"]),
        "actf.0.weight": torch.from_numpy(p["bn"]["scale"]),
        "actf.0.bias": torch.from_numpy(p["bn"]["bias"]),
        "actf.0.running_mean": torch.from_numpy(bs["bn"]["mean"]),
        "actf.0.running_var": torch.from_numpy(bs["bn"]["var"]),
        "actf.0.num_batches_tracked": torch.zeros((), dtype=torch.int64),
    })
    with torch.no_grad():
        out = port(_nhwc(x))
    _assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_conv_matches_flax(factor):
    """Depthwise transposed conv: the flax kernel [2f,2f,1,C] goes over as
    [C,1,2f,2f] with no flip. A random (asymmetric) kernel shows a wrong flip."""
    rng = np.random.RandomState(factor)
    x = rng.randn(2, 5, 7, 8).astype(np.float32)
    kernel = rng.randn(2 * factor, 2 * factor, 1, 8).astype(np.float32)
    mod = jax_layers.UpsampleConv(factor)
    ref = mod.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))

    port = layers.UpsampleConv(8, factor)
    init = port.weight.detach().clone()
    np.testing.assert_allclose(   # the bilinear init is the JAX package's
        init[:, 0].numpy(),
        np.broadcast_to(np.asarray(jax_layers._bilinear_upsample_kernel(factor)), init[:, 0].shape),
        atol=1e-7,
    )
    port.load_state_dict({"weight": torch.from_numpy(_t_conv(kernel))})
    with torch.no_grad():
        out = port(_nhwc(x))
    _assert_close(out, ref, 1e-5)


def test_conv_gru_matches_flax():
    """Six per-gate convs here, fused and hoisted projections there: the same
    sums in another order, atol 1e-5. h0 = 0, the same x at every step."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    mod = jax_gru.ConvGRU(steps=3, hidden=8)
    variables = randomize_variables(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))   # [steps, B, H, W, hidden]

    port = conv_gru.ConvGRU(16, steps=3, hidden=8)
    sd = {}
    for gate, leaves in variables["params"]["cell0"].items():
        sd[f"cell0.{gate}.weight"] = torch.from_numpy(_t_conv(leaves["kernel"]))
        if "bias" in leaves:
            sd[f"cell0.{gate}.bias"] = torch.from_numpy(leaves["bias"])
    port.load_state_dict(sd)
    with torch.no_grad():
        states = port(_nhwc(x))
    assert len(states) == 3
    for step, h in enumerate(states):
        _assert_close(h, ref[step], 1e-5)


@pytest.mark.parametrize("use_gn", [True, False])
def test_head_conv_matches_flax(use_gn):
    """3x3 conv -> GroupNorm(32, eps 1e-5) -> ReLU -> 1x1 conv, atol 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mod = jax_layers.HeadConv(3, head_conv=64, use_gn=use_gn, bias_init_value=-2.19)
    variables = randomize_variables(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = mod.apply(variables, jnp.asarray(x))

    port = layers.HeadConv(16, 3, head_conv=64, use_gn=use_gn, bias_init_value=-2.19)
    assert port[-1].bias.detach()[0].item() == pytest.approx(-2.19)
    sd = from_jax_variables({"params": {"hm": variables["params"]}})
    port.load_state_dict({k[len("hm."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = port(_nhwc(x))
    _assert_close(out, ref, 1e-5)


def _whole_network(preset_name, model, variables):
    rng = np.random.RandomState(11)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x))
    port = create_model(preset(preset_name, input_h=SIZE, input_w=SIZE), device="cpu")
    load_jax_variables(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert list(out) == list(port.config.heads) and set(out) == set(ref)
    # The offset convs are live: the DCN blocks really sample off-grid.
    om = port.ida_up.node_2.conv.conv_offset_mask.weight
    assert om.abs().max() > 0
    for head in out:
        o, r = out[head].numpy(), np.asarray(ref[head])
        assert o.shape == r.shape == (2, SIZE // 4, SIZE // 4, port.config.heads[head])
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(o, r, atol=2e-4, rtol=0, err_msg=head)


def test_dlav1_34_matches_jax(flagship):
    """The flagship network, all 7 head maps, atol 2e-4."""
    _whole_network("centerpose", *flagship)


def test_dla_34_matches_jax():
    """The same trunk and neck without the convGRU chain (plain heads)."""
    _whole_network("centerpose_dla", *jax_model_and_variables("centerpose_dla", seed=1))


def test_unported_paths_raise():
    """What is still not ported raises: the dlav1 + tracking GRU routing; an
    arch the factory does not know is refused."""
    with pytest.raises(NotImplementedError):      # dlav1 + tracking GRU routing
        create_model(preset("centerpose", tracking_task=True), device="cpu")
    for arch in ("nope_1", "res_19", "res_x", "resdcn"):
        with pytest.raises(ValueError):
            create_model(preset("centerpose", arch=arch), device="cpu")


@pytest.mark.parametrize("arch,size,module", [
    ("dla_34", 64, "CenterPoseNet"), ("dlav1_34", 64, "CenterPoseNet"),
    ("dlav0_34", 64, "CenterPoseNetV0"), ("res_34", 64, "PoseResNet"),
    ("resdcn_50", 64, "PoseResNet"), ("hourglass", 128, "HourglassNet"),
])
def test_every_family_builds_on_the_cpu(arch, size, module):
    """All six architecture families of the JAX factory build, seeded, on
    the CPU, and map an NHWC batch to NHWC heads at stride 4."""
    cfg = preset("centerpose_dla", arch=arch, input_h=size, input_w=size)
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert type(model).__name__ == module and not model.training
    with torch.no_grad():
        out = model(torch.zeros(1, size, size, 3))
    assert list(out) == list(cfg.heads)
    assert all(tuple(v.shape) == (1, size // 4, size // 4, cfg.heads[k]) for k, v in out.items())


def test_create_model_is_seeded_and_leaves_global_rng_alone():
    cfg = preset("centerpose_dla", input_h=SIZE, input_w=SIZE)
    torch.manual_seed(5)
    before = torch.get_rng_state()
    a = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(before, torch.get_rng_state())
    b = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["hps.0.weight"], sc["hps.0.weight"])
    assert float(sa["hm.2.bias"][0]) == pytest.approx(-2.19)
    assert float(sa["hm_hp.2.bias"][0]) == pytest.approx(-2.19)
    assert float(sa["wh.2.bias"].abs().max()) == 0.0
    assert float(sa["ida_up.proj_1.conv.conv_offset_mask.weight"].abs().max()) == 0.0
    assert not a.training
