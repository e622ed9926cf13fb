"""The PyTorch package's dlav0_34 and its `head_conv <= 0` heads against the
JAX package's, on the CPU.

* dlav0's neck (`DLAUpV0` / `IDAUpV0`: 1x1 projections, depthwise bilinear
  upsamplers, 3x3 nodes over concatenated pairs) as a module, atol 1e-5;
  the whole dlav0_34 at 64x64, atol 1e-4 (no DCN); one float32 train step
  against the JAX package's `make_train_step`, held as the resnet steps are
  (`test_torch_port_resnet.py::StepPair`).
* `head_conv = 0`: the bare 1x1 conv head as a module (1e-5), and dla_34
  (plain branch) and dlav1_34 (the convGRU branch without `SplitHeadConv`) as
  whole networks, atol 2e-4 (DCN architectures).
* The reference-names round trip through the JAX package's converter:
  dlav0_34 with the trunk's ImageNet classifier (`base.fc.*`) in the
  checkpoint, which both loaders pass over; and a `head_conv = 0` checkpoint,
  whose reference names (`hm.weight`) the JAX converter does not read: it
  asks for `hm.2.weight` (ROADMAP.md, queue C), so the round trip renames
  the heads' keys to what it asks for, and the port's own loader takes the
  reference's names.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.models import dla as jax_dla
from centerpose_tpu.models import layers as jax_layers
from centerpose_tpu.models.convert import convert_state_dict
from centerpose_tpu_torch.models import dla, layers
from centerpose_tpu_torch.models.convert import from_jax_variables
from centerpose_tpu_torch.models.factory import create_model
from tests.test_torch_port_model import randomize_variables
from tests.test_torch_port_resnet import (
    TOL_DCN,
    TOL_PLAIN,
    StepPair,
    forward_matches,
    jax_config,
    port_config,
    randomize_port,
    reference_round_trip,
    release_memory,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _sub_state_dict(variables, name):
    """The port's state_dict of a module that sits at `name` in a network."""
    sd = from_jax_variables({c: {name: t} for c, t in variables.items()})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def test_dlav0_neck_matches_flax():
    """`DLAUpV0` over a 4-level pyramid (64 -> 8 channels, strides 1..8):
    projections where widths differ, upsamplers x2 / x4 / x8, nodes over
    concatenations; the stride-1 aggregate, atol 1e-5."""
    rng = np.random.RandomState(0)
    chans = (8, 16, 32, 64)
    levels = [rng.randn(2, 16 >> i, 16 >> i, c).astype(np.float32) for i, c in enumerate(chans)]
    mod = jax_dla.DLAUpV0(chans)
    variables = randomize_variables(mod.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in levels]), 1)
    ref = mod.apply(variables, [jnp.asarray(x) for x in levels])

    port = dla.DLAUpV0(chans).eval()
    port.load_state_dict(_sub_state_dict(variables, "dla_up"))
    assert [n for n, _ in port.named_children()] == ["ida_0", "ida_1", "ida_2"]
    assert hasattr(port.ida_2, "up_3") and not hasattr(port.ida_2, "proj_0")
    with torch.no_grad():
        out = port([_nchw(x) for x in levels])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bare_head_matches_flax():
    """`head_conv <= 0`: one 1x1 conv with bias (-2.19 on a heatmap head),
    named as the reference's bare conv (`weight`, `bias`)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    mod = jax_layers.HeadConv(3, head_conv=0, bias_init_value=-2.19)
    variables = randomize_variables(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    assert set(variables["params"]) == {"out"}
    port = layers.make_head(16, 3, 0, use_gn=True, bias_init_value=-2.19)
    assert isinstance(port, layers.BareHead) and float(port.bias[0].detach()) == pytest.approx(-2.19)
    sd = _sub_state_dict(variables, "hm")
    assert set(sd) == {"weight", "bias"}
    port.load_state_dict(sd)
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(mod.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_dlav0_34_matches_jax():
    forward_matches("dlav0_34", seed=8, atol=TOL_PLAIN)


@pytest.mark.parametrize("arch", ["dla_34", "dlav1_34"])
def test_head_conv_0_matches_jax(arch):
    """dla_34 (plain branch) and dlav1_34 (heads on the convGRU states) with
    single 1x1 conv heads, every head, atol 2e-4."""
    port, _ = forward_matches(arch, seed=9, atol=TOL_DCN, head_conv=0)
    assert isinstance(port.hm, layers.BareHead) and "hm.weight" in port.state_dict()


@pytest.fixture(scope="module")
def step_pair():
    return StepPair("dlav0_34", seed=10)


def test_train_step_loss_and_stats(step_pair):
    step_pair.check_loss_and_stats()


def test_train_step_gradients_with_running_statistics(step_pair):
    step_pair.check_running_statistics_gradients()


def test_train_step_gradients(step_pair):
    step_pair.check_step_gradients()


def test_train_step_running_stats(step_pair):
    step_pair.check_running_stats()


def test_dlav0_reference_names_round_trip():
    """A released dlav0 checkpoint keeps the trunk's classifier; both
    converters pass over `base.fc.*`."""
    extra = {"base.fc.weight": np.zeros((1000, 512, 1, 1), np.float32),
             "base.fc.bias": np.zeros((1000,), np.float32)}
    sd = reference_round_trip(port_config("dlav0_34"), jax_config("dlav0_34"), seed=11,
                              atol=TOL_PLAIN, extra=extra)
    assert "dla_up.ida_0.node_1.0.weight" in sd and "dla_up.ida_2.up_3.weight" in sd


def test_head_conv_0_reference_names():
    """A head_conv = 0 dla_34: the port's keys are the reference's
    (`hm.weight`); the JAX converter asks for `hm.2.weight` instead (a
    fault of the JAX package, left as it is) and refuses the reference's
    names, and reads the checkpoint once renamed."""
    cfg, jcfg = port_config("dla_34", head_conv=0), jax_config("dla_34", head_conv=0)
    heads = tuple(cfg.heads)
    port = randomize_port(create_model(cfg, device="cpu"), 12)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {f"{h}.weight" for h in heads} <= set(sd) and not any(k.startswith("hm.2") for k in sd)
    from centerpose_tpu.models import create_model as jax_create_model

    model = jax_create_model(jcfg)
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))))
    with pytest.raises(KeyError, match=r"hm\.2\.(weight|bias)"):
        convert_state_dict(sd, like, use_gn=False, strict=True)
    rename = {f"{h}.{leaf}": f"{h}.2.{leaf}" for h in heads for leaf in ("weight", "bias")}
    reference_round_trip(cfg, jcfg, seed=12, atol=TOL_DCN, rename=rename)
