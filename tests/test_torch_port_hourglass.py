"""The PyTorch package's hourglass network against the JAX package's, on the
CPU: the CornerNet 2-stack large hourglass at 128x128 (its five halvings
below stride 4 need an input side of at least 128), the last stack's heads
and every stack's with `return_all_stacks`, then the reference-names round
trip through the JAX package's converter (see `test_torch_port_resnet.py`).

The kp modules run at narrow widths, `DIMS_T` in place of (256, 256, 384,
384, 384, 512), on both sides (each package's module-level `DIMS` is
patched: the JAX module reads it when it is applied, the port's when it is
built): the full network's ~190M parameters would make
this file's copies of them several GB. The outer width (256: the stem's,
the inter-stack modules' and the heads') and the residual counts are the
real ones, and the widths still change at every kind of level boundary, so
every name and every skip connection of the full network is exercised. The
JAX variables' shapes come from `jax.eval_shape` and are drawn with numpy
from a seed. float32, atol 1e-4 (a plain-conv network).
"""

import contextlib

import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.models import hourglass as jax_hourglass
from centerpose_tpu_torch.models import hourglass
from centerpose_tpu_torch.models.convert import load_jax_variables
from centerpose_tpu_torch.models.factory import reset_parameters
from tests.test_torch_port_resnet import (
    TOL_PLAIN,
    assert_heads_close,
    image,
    jax_config,
    jax_model_and_variables,
    port_config,
    reference_round_trip,
    release_memory,
)

SIZE = 128
DIMS_T = (256, 64, 64, 96, 96, 128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


@contextlib.contextmanager
def narrow_hourglass():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hourglass, "DIMS", DIMS_T)
        mp.setattr(hourglass, "DIMS", DIMS_T)
        yield


def port_hourglass(cfg, seed, return_all_stacks=False):
    with narrow_hourglass():
        model = hourglass.HourglassNet(cfg, return_all_stacks=return_all_stacks)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def hourglass_pair():
    """The JAX network returning every stack, its variables, one input and
    its outputs."""
    jcfg = jax_config("hourglass", SIZE)
    with narrow_hourglass():
        model, variables = jax_model_and_variables(
            jcfg, seed=6, model=jax_hourglass.HourglassNet(jcfg, return_all_stacks=True))
        x = image(16, SIZE, batch=1)
        ref = model.apply(variables, jnp.asarray(x))
    return variables, x, ref


@pytest.mark.parametrize("all_stacks", [False, True])
def test_hourglass_matches_jax(hourglass_pair, all_stacks):
    """The last stack's heads (what the detector and the trainer read), and
    with `return_all_stacks` both stacks' heads, each against the JAX
    stack's; the first stack's differ from the last's."""
    variables, x, ref = hourglass_pair
    cfg = port_config("hourglass", SIZE)
    port = port_hourglass(cfg, 0, return_all_stacks=all_stacks)
    load_jax_variables(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    if not all_stacks:
        assert_heads_close(out, ref[-1], cfg, TOL_PLAIN)
        return
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert_heads_close(o, r, cfg, TOL_PLAIN)
    assert float((out[0]["hm"] - out[1]["hm"]).abs().max()) > 1e-3


def test_hourglass_names_and_head_width():
    """The reference's names: the nested `low2` modules, the inter-stack
    modules for stacks < 1 only, per-stack heads 256 wide whatever
    `head_conv` says; the widths and residual counts are the JAX package's."""
    assert hourglass.DIMS == jax_hourglass.DIMS and hourglass.MODULES == jax_hourglass.MODULES
    sd = port_hourglass(port_config("hourglass", SIZE, head_conv=64), 0).state_dict()
    assert tuple(sd["kps.0.low2.low2.low2.low2.low2.3.conv2.weight"].shape) == (128, 128, 3, 3)
    assert "kps.1.low1.0.skip.0.weight" in sd and "kps.1.up1.0.skip.0.weight" not in sd
    assert {k.split(".")[1] for k in sd if k.startswith(("inters.", "inters_.", "cnvs_."))} == {"0"}
    assert tuple(sd["hm.1.0.conv.weight"].shape) == (256, 256, 3, 3)
    assert tuple(sd["hps.0.1.weight"].shape) == (16, 256, 1, 1)
    assert "pre.0.conv.weight" in sd and "pre.0.conv.bias" not in sd and "hm.0.0.conv.bias" in sd


def test_hourglass_reference_names_round_trip():
    with narrow_hourglass():
        reference_round_trip(port_config("hourglass", SIZE), jax_config("hourglass", SIZE), seed=7,
                             atol=TOL_PLAIN, size=SIZE, build=port_hourglass)
