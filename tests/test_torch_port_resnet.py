"""The PyTorch package's ResNet networks (res_*, resdcn_*) against the JAX
package's, on the CPU, and the helpers the other architectures' files share.

Weights are drawn on the JAX side (the tree's shapes from `jax.eval_shape`,
kernels as torch's default init draws them, then `randomize_variables`: norm statistics,
biases and DCN offset convs re-drawn) and carried across with
`models/convert.py::load_jax_variables`; the same numpy input goes through
both. float32; the JAX side runs its exact gather DCN (`dcn_impl="gather"`)
at `jax_default_matmul_precision=highest` (tests/conftest.py). Tolerances:
1e-5 per module, 1e-4 for a whole plain-conv network and 2e-4 for a DCN one
(the JAX package's own bounds, tests/test_validate_pth.py:25-33).

Also here:
* the transposed conv of the deconv stages with the msra uniform init and
  resdcn's bilinear one (output channel 0 only), held to the flax module;
* one float32 train step of res_18 and of resdcn_18 at 64x64, batch 2,
  against `centerpose_tpu.training.trainer.make_train_step` (loss and stats,
  gradients, running statistics), held as `test_torch_port_training.py`
  holds the flagship's;
* the kernels' plans at resdcn_50's first DCN (16x16, 2048 -> 256);
* the reference-names round trip: the port's own `state_dict` goes through
  the JAX package's `convert_state_dict(..., strict=True)` (the converter
  that reads a released `.pth`), and the JAX network on the result gives the
  port's outputs; `load_reference_state_dict` takes the same checkpoint
  wrapped as `{epoch, state_dict}` with `module.` prefixes.
"""

import ctypes
import gc

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu.models import layers as jax_layers
from centerpose_tpu.models.convert import convert_state_dict
from centerpose_tpu.training import trainer as jax_trainer
from centerpose_tpu.training.losses import centerpose_loss as jax_centerpose_loss
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import targets
from centerpose_tpu_torch.models import layers
from centerpose_tpu_torch.models.convert import (
    _t_deconv,
    from_jax_variables,
    load_jax_variables,
    load_reference_state_dict,
    to_jax_tree,
)
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops import dcn_bwd
from centerpose_tpu_torch.ops.dcn_bwd import bwd_plan
from centerpose_tpu_torch.ops.dcn_fwd import bf16_plan, f32_plan
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.training.losses import centerpose_loss
from tests.test_torch_port_model import randomize_variables
from tests.test_torch_port_training import annotations

SIZE = 64
BATCH = 2
TOL_PLAIN, TOL_DCN = 1e-4, 2e-4


def release_memory():
    """Hand this file's memory back before the worker's next file: JAX's
    compiled programs, then the heap pages glibc keeps after frees (1.3 GB
    after this file; the suite's workers share the host's memory with one
    test that takes 38 GB)."""
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):          # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: small eager convolutions gain nothing from a
    pool, and under the suite's parallel workers pools oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


# ------------------------------------------------------------ shared helpers
def jax_config(arch, size=SIZE, **overrides):
    return jax_preset("centerpose_dla", arch=arch, input_h=size, input_w=size,
                      dcn_impl="gather", dcn_bwd="autodiff", remat_dcn=False,
                      remat_stem=False, **overrides)


def port_config(arch, size=SIZE, **overrides):
    return preset("centerpose_dla", arch=arch, input_h=size, input_w=size, **overrides)


def jax_model_and_variables(cfg, seed, model=None):
    """The JAX model of `cfg` (or `model`) and random variables for it: the
    tree's shapes from an abstract init, kernels drawn uniform in
    +-1/sqrt(fan_in) (torch's default conv init, the reference's, under which
    the JAX package set the bounds used here), the rest by
    `randomize_variables`."""
    model = model if model is not None else jax_create_model(cfg)
    z = jnp.zeros((1, cfg.input_h, cfg.input_w, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), z))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("kernel", "weight"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32) / np.float32(np.sqrt(fan_in))
        return np.full(leaf.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)

    return model, randomize_variables(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def image(seed, size=SIZE, batch=BATCH):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


def assert_heads_close(out, ref, cfg, atol, stride=4):
    """Every head: its shape, a live value, the JAX value within atol."""
    assert list(out) == list(cfg.heads) and set(out) == set(ref)
    for head in out:
        o, r = out[head].detach().numpy(), np.asarray(ref[head])
        side = cfg.input_h // stride
        assert o.shape == r.shape == (r.shape[0], side, side, cfg.heads[head]), head
        assert np.abs(r).max() > 1e-3, head
        np.testing.assert_allclose(o, r, atol=atol, rtol=0, err_msg=head)


def port_from_jax(cfg, variables):
    port = create_model(cfg, device="cpu")
    load_jax_variables(port, variables)
    return port


def forward_matches(arch, seed, atol, size=SIZE, **overrides):
    """The JAX network and the port's on the same weights and input."""
    jcfg = jax_config(arch, size, **overrides)
    model, variables = jax_model_and_variables(jcfg, seed)
    x = image(seed + 100, size)
    ref = model.apply(variables, jnp.asarray(x))
    cfg = port_config(arch, size, **overrides)
    port = port_from_jax(cfg, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert_heads_close(out, ref, cfg, atol)
    return port, variables


def randomize_port(model, seed):
    """The port's own random weights made non-trivial (no JAX involved):
    BatchNorm statistics and affine, every conv bias, DCN offset convs."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                draw(mod.weight, 0.6, 1.4)
                draw(mod.running_var, 0.6, 1.4)
                draw(mod.bias, -0.1, 0.1)
                draw(mod.running_mean, -0.1, 0.1)
            elif isinstance(mod, torch.nn.Conv2d) and mod.bias is not None:
                mod.bias.add_(torch.rand(mod.bias.shape, generator=gen) * 0.1 - 0.05)
            if isinstance(mod, layers.DCN):
                w = mod.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.5 / w[0].numel() ** 0.5)
    return model


def seeded_model(cfg, seed):
    return create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def reference_round_trip(cfg, jcfg, seed, atol, use_gn=False, rename=None, extra=None,
                         jax_model=None, size=SIZE, build=seeded_model):
    """The port model's own state_dict, as numpy, through the JAX package's
    `convert_state_dict(strict=True)`; JAX apply on the result gives the
    port's outputs. `rename` maps port keys to the names the JAX converter
    reads where they differ; `extra` adds keys a released checkpoint carries
    (which both loaders must pass over). Then the same checkpoint, wrapped
    as the reference saves it, loads into a fresh port model through
    `load_reference_state_dict` and gives the same bits. `build(cfg, seed)`
    makes the port's model."""
    port = randomize_port(build(cfg, seed), seed)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    sd.update(extra or {})
    jsd = {(rename or {}).get(k, k): v for k, v in sd.items()}
    model = jax_model if jax_model is not None else jax_create_model(jcfg)
    z = jnp.zeros((1, size, size, 3), jnp.float32)
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), z)))
    variables = convert_state_dict(jsd, like, use_gn=use_gn, strict=True)
    x = image(seed + 7, size)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert_heads_close(out, ref if isinstance(ref, dict) else ref[-1], cfg, atol)

    fresh = build(cfg, seed + 1)
    ckpt = {"epoch": 3, "state_dict": {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}
    load_reference_state_dict(fresh, ckpt)
    with torch.no_grad():
        again = fresh(torch.from_numpy(x))
    for head in out:
        assert torch.equal(again[head], out[head]), head
    return sd


def synthetic_batch(cfg, seed):
    rng = np.random.RandomState(seed)
    samples = [targets.render_targets(annotations(targets, cfg, rng), cfg) for _ in range(BATCH)]
    batch = targets.stack_batch(samples)
    batch["input"] = rng.randn(BATCH, cfg.input_h, cfg.input_w, 3).astype(np.float32)
    return batch


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def _recorder():
    """An optax transformation whose state after an update is the gradient
    it was given (and whose update is 0): the JAX train step then hands its
    gradients back in `opt_state`."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


class StepPair:
    """One float32 train step of the same network in both packages, from the
    same weights on the same batch: the JAX step is the package's own
    `make_train_step` (with an optimizer that records the gradients); plus
    the eval-mode loss and its gradients (BatchNorm on running statistics)
    in both, in float64."""

    def __init__(self, arch, seed):
        self.jcfg = jax_config(arch, batch_size=BATCH)
        self.cfg = port_config(arch, batch_size=BATCH)
        self.jmodel, self.variables = jax_model_and_variables(self.jcfg, seed)
        self.batch = synthetic_batch(self.cfg, seed)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        params = jax.tree_util.tree_map(jnp.asarray, self.variables["params"])
        bstats = jax.tree_util.tree_map(jnp.asarray, self.variables["batch_stats"])
        copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)     # noqa: E731 (the step donates its state)
        state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=copy(params),
                                       batch_stats=copy(bstats), opt_state=_recorder().init(params))
        new, self.jstats = jax_trainer.make_train_step(self.jcfg, self.jmodel, _recorder())(state, jbatch)
        self.jgrads, self.jnew_bs = new.opt_state, new.batch_stats
        self.jnorm = float(optax.global_norm(self.jgrads))
        self.jeval_loss, self.jeval_grads = self._jax_float64_eval_gradients()

        self.model = port_from_jax(self.cfg, self.variables)
        self.eval_loss, self.eval_grads = self._port_float64_eval_gradients()
        tstate, tx = trainer.create_train_state(self.cfg, self.model)
        _, self.stats = trainer.make_train_step(self.cfg, self.model, tx)(tstate, self.batch)
        self.norm = float(tx.norm)
        self.grads = {k: p.grad for k, p in self.model.named_parameters()}

    def _jax_float64_eval_gradients(self):
        """The JAX eval-mode loss and its gradients, in float64 throughout."""
        with jax.enable_x64(True):
            cfg = self.jcfg.replace(compute_dtype="float64")
            model = jax_create_model(cfg)
            f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
            params, bstats = f64(self.variables["params"]), f64(self.variables["batch_stats"])
            batch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                     for k, v in self.batch.items()}
            loss_cfg = jax_trainer.loss_config_from(cfg)

            def eval_loss(p):
                out = model.apply({"params": p, "batch_stats": bstats}, batch["input"], train=False)
                return jax_centerpose_loss(out, batch, loss_cfg, "train")[0]

            loss, grads = jax.jit(jax.value_and_grad(eval_loss))(params)
            return float(loss), jax.tree_util.tree_map(np.asarray, grads)

    def _port_float64_eval_gradients(self):
        model = create_model(self.cfg, device="cpu")
        load_jax_variables(model, self.variables)
        model = model.double()
        batch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        loss = centerpose_loss(model(batch["input"]), batch, trainer.loss_config_from(self.cfg), "train")[0]
        loss.backward()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}

    def check_loss_and_stats(self):
        """loss and every stat, rtol = atol = 1e-4."""
        assert set(self.stats) == set(self.jstats)
        for k, ref in self.jstats.items():
            np.testing.assert_allclose(self.stats[k].item(), float(ref), rtol=1e-4, atol=1e-4, err_msg=k)
        assert np.isfinite(self.stats["loss"].item())
        assert self.norm == pytest.approx(self.jnorm, rel=1e-2)

    def check_running_statistics_gradients(self):
        """Every parameter's gradient of the loss with BatchNorm on running
        statistics, tree against tree: where each layer's backward is held
        tightly. In float64 on both sides: in float32 a pre-activation that
        lands within float32 noise of 0 makes its ReLU's gradient a coin
        toss between the packages (res_18 at this seed has one, 1.4e-8
        before its last deconv stage's ReLU, which moves the gradients
        behind it by 1e-3 of their largest value while the JAX float32
        gradient and the port's float64 one agree to 5e-7). Bound: 1e-5 of
        the leaf's largest magnitude (measured: 7e-8 res_18, 6e-7
        resdcn_18)."""
        np.testing.assert_allclose(self.eval_loss, self.jeval_loss, rtol=1e-7)
        named = {k: torch.zeros_like(p) if self.eval_grads[k] is None else self.eval_grads[k]
                 for k, p in self.model.named_parameters()}
        got = to_jax_tree(named, {"params": self.variables["params"]})["params"]
        ref_leaves, got_leaves = _leaves(self.jeval_grads), _leaves(got)
        assert len(ref_leaves) == len(got_leaves) == len(named)
        for (path, r), (_, g) in zip(ref_leaves, got_leaves):
            r = np.asarray(r)
            scale = float(np.abs(r).max())
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale + 1e-12, err_msg=str(path))

    def check_step_gradients(self):
        """The train step's gradients (batch statistics; `.grad` holds them
        clipped to norm 100): each leaf within 25 % in relative L2, the tree
        within 5 % (float32 holds them to about a percent through the
        BatchNorms on a batch of 2, test_torch_port_training.py)."""
        clip = min(1.0, self.cfg.grad_clip_norm / self.norm)
        got = to_jax_tree(self.grads, {"params": self.variables["params"]})["params"]
        ref_leaves, got_leaves = _leaves(self.jgrads), _leaves(got)
        n_held = 0
        for (path, r), (_, g) in zip(ref_leaves, got_leaves):
            r = np.asarray(r) * clip
            if np.linalg.norm(r) < 1e-6 * self.cfg.grad_clip_norm:    # 0 up to float noise
                assert np.linalg.norm(g) < 1e-5 * self.cfg.grad_clip_norm, path
                continue
            assert _rel_l2(g, r) < 0.25, (path, _rel_l2(g, r))
            n_held += 1
        assert n_held > len(ref_leaves) // 2
        flat_g = np.concatenate([g.ravel() for _, g in got_leaves])
        flat_r = np.concatenate([np.asarray(r).ravel() for _, r in ref_leaves]) * clip
        assert _rel_l2(flat_g, flat_r) < 0.05

    def check_running_stats(self):
        """running_mean directly, running_var after flax's biased / torch's
        unbiased batch variance (n / (n - 1), n = B*H*W of the layer)."""
        counts = {}
        probe = create_model(self.cfg, device="cpu").train()
        load_jax_variables(probe, self.variables)
        hooks = [m.register_forward_hook(lambda mod, inp, _o: counts.__setitem__(
                    mod, inp[0].numel() // inp[0].shape[1]))
                 for m in probe.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        with torch.no_grad():
            probe(torch.from_numpy(self.batch["input"]))
        for h in hooks:
            h.remove()
        names = {mod: name for name, mod in probe.named_modules()}
        old = from_jax_variables(self.variables)
        buffers = dict(self.model.named_buffers())
        corrected = dict(buffers)
        for mod, n in counts.items():
            key = names[mod] + ".running_var"
            unbiased = (buffers[key] - 0.9 * old[key]) / 0.1
            corrected[key] = 0.9 * old[key] + 0.1 * unbiased * (n - 1) / n
        got = to_jax_tree(corrected, {"batch_stats": self.variables["batch_stats"]})["batch_stats"]
        ref_leaves, got_leaves = _leaves(self.jnew_bs), _leaves(got)
        assert len(ref_leaves) == len(got_leaves) == 2 * len(counts)
        for (path, r), (_, g) in zip(ref_leaves, got_leaves):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=str(path))


# ------------------------------------------------------------------- modules
@pytest.mark.parametrize("bilinear", [False, True])
def test_transposed_conv_matches_flax(bilinear):
    """`TorchConvTranspose` (ConvTranspose2d(cin, cout, 4, 2, 1), no bias)
    against the flax module: its own init first (msra: uniform within
    +-1/sqrt(cin * 16); resdcn: the bilinear stencil in output channel 0
    only, 0 elsewhere), then a random kernel of no symmetry carried across
    by `_t_deconv` with no flip; atol 1e-5."""
    rng = np.random.RandomState(int(bilinear))
    x = rng.randn(2, 5, 7, 8).astype(np.float32)
    mod = jax_layers.TorchConvTranspose(6, 4, 2, 1, bilinear_init=bilinear)
    init = np.asarray(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]["kernel"])
    port = layers.TorchConvTranspose(8, 6, bilinear_init=bilinear)
    w = port.weight.detach().numpy()
    assert w.shape == (8, 6, 4, 4)
    if bilinear:
        np.testing.assert_array_equal(w, _t_deconv(init))
        assert np.abs(w[:, 1:]).max() == 0 and np.abs(w[:, 0]).min() > 0
    else:
        bound = 1 / np.sqrt(8 * 16)
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound
        assert np.abs(init).max() <= bound

    kernel = rng.randn(4, 4, 8, 6).astype(np.float32)
    ref = mod.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    port.load_state_dict({"weight": torch.from_numpy(_t_deconv(kernel))})
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert out.shape == (2, 6, 10, 14)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_create_model_inits_the_deconv_stages():
    """The factory's seeded init: msra transposed convs uniform in
    +-1/sqrt(cin * 16) (fan-in over the input channels, not the weight's
    first dimension's slice), resdcn's bilinear in channel 0, heatmap biases
    -2.19, DCN offset convs 0."""
    sd = create_model(port_config("res_18"), device="cpu").state_dict()
    w = sd["deconv_layers.0.weight"]
    assert tuple(w.shape) == (512, 256, 4, 4)
    assert 0.9 / np.sqrt(512 * 16) < float(w.abs().max()) <= 1 / np.sqrt(512 * 16)
    assert float(sd["hm.2.bias"][0]) == pytest.approx(-2.19)
    sd = create_model(port_config("resdcn_18"), device="cpu").state_dict()
    up = sd["deconv_layers.3.weight"]
    assert tuple(up.shape) == (256, 256, 4, 4) and float(up[:, 1:].abs().max()) == 0.0
    np.testing.assert_allclose(up[:, 0].numpy(), np.broadcast_to(
        np.asarray(jax_layers._bilinear_upsample_kernel(2)), (256, 4, 4)))
    assert float(sd["deconv_layers.0.conv_offset_mask.weight"].abs().max()) == 0.0
    assert tuple(sd["deconv_layers.0.weight"].shape) == (256, 512, 3, 3)
    assert "deconv_layers.4.running_var" in sd and "deconv_layers.1.running_var" in sd


# ----------------------------------------------------------- whole networks
@pytest.mark.parametrize("arch", ["res_18", "res_50"])
def test_resnet_matches_jax(arch):
    """The msra networks, basic (18) and bottleneck (50) blocks, every head
    at 64x64, atol 1e-4."""
    port, _ = forward_matches(arch, seed=1, atol=TOL_PLAIN)
    assert sum(isinstance(m, layers.TorchConvTranspose) for m in port.modules()) == 3


def test_resdcn_18_matches_jax():
    """resdcn_18 with live offset convs (its three DCN stages sample off the
    grid), every head, atol 2e-4."""
    port, _ = forward_matches("resdcn_18", seed=2, atol=TOL_DCN)
    dcns = [m for m in port.modules() if isinstance(m, layers.DCN)]
    assert len(dcns) == 3 and all(float(m.conv_offset_mask.weight.detach().abs().max()) > 0 for m in dcns)


@pytest.fixture(scope="module", params=["res_18", "resdcn_18"])
def step_pair(request):
    return StepPair(request.param, seed=3)


def test_train_step_loss_and_stats(step_pair):
    step_pair.check_loss_and_stats()


def test_train_step_gradients_with_running_statistics(step_pair):
    step_pair.check_running_statistics_gradients()


def test_train_step_gradients(step_pair):
    step_pair.check_step_gradients()


def test_train_step_running_stats(step_pair):
    step_pair.check_running_stats()


# ------------------------------------------------------- reference names
@pytest.mark.parametrize("arch,atol", [("res_18", TOL_PLAIN), ("resdcn_18", TOL_DCN), ("res_50", TOL_PLAIN)])
def test_reference_names_round_trip(arch, atol):
    """The port's state_dict is what the JAX converter reads from a released
    `.pth`: every key consumed, every leaf filled (strict), the same outputs."""
    sd = reference_round_trip(port_config(arch), jax_config(arch), seed=4, atol=atol)
    assert "layer1.0.conv1.weight" in sd and "deconv_layers.4.running_var" in sd


def test_from_jax_and_to_jax_are_inverse():
    """`from_jax_variables` then `to_jax_tree` is the identity on a resdcn
    tree, whose names depend on the tree (BN at 6i + 4)."""
    _, variables = jax_model_and_variables(jax_config("resdcn_18"), seed=5)
    sd = from_jax_variables(variables)
    back = to_jax_tree(sd, variables)
    for (path, r), (_, g) in zip(_leaves(variables), _leaves(back)):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
    assert "deconv_layers.4.running_mean" in sd and "deconv_layers.1.running_mean" in sd


# ------------------------------------------- resdcn_50's first DCN stage
# At 512x512 the first DCN of resdcn_50 reads the stride-32 map of 2048
# channels: 16x16, C = 2048 -> Co = 256, K = 9 * 2048, a K no DLA shape has.
R50_H, R50_C, R50_CO = 16, 2048, 256


@pytest.mark.parametrize("b", [8, 1])
def test_forward_plans_take_resdcn_50s_first_dcn(b):
    """Both forward bodies take it: the float32 one splits its 576 steps of
    32 channels over enough ranges for one wave (the grid is under 132
    blocks) and states the scratch (the weight's hi/lo copy + the
    partials); the bf16 one tiles it as any shape; shared memory fits."""
    plan = f32_plan(b, R50_H, R50_H, R50_C, R50_CO)
    gx, gy = -(-b * R50_H * R50_H // 64), 2
    steps = 9 * R50_C // 32
    assert plan["block_n"] == 128 and plan["grid"] == [gx, gy]
    assert plan["split"] == min(-(-132 // (gx * gy)), steps // 4) > 1
    assert plan["scratch_bytes"] == 4 * (2 * 9 * R50_C * R50_CO + plan["split"] * b * R50_H * R50_H * R50_CO)
    assert plan["smem_bytes"] <= 227 * 1024
    bf = bf16_plan(b, R50_H, R50_H, R50_C, R50_CO)
    assert bf["grid"] == [gx, gy] and bf["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("kind", ["fused", "dx", "dcoord", "dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plans_take_resdcn_50s_first_dcn(kind, dtype):
    """The four backward kernels at B=8: shared memory fits one SM; the dW
    partials of a slab grid would exceed the scratch cap (4 * 9 * 2048 * 256
    bytes > 16 MiB), so the kernels with dW run one slab; the scratch is the
    weight's fragments (float32 hi and lo, or bf16 pairs along K steps of
    16) plus the coordinate partials of the channel groups."""
    plan = bwd_plan(kind, 8, R50_H, R50_H, R50_C, R50_CO, dtype=dtype)
    wsize = 9 * R50_C * R50_CO
    assert plan["smem_bytes"] + 1024 <= 228 * 1024 and plan["blocks_per_sm"] >= 1
    if kind in ("fused", "dw"):
        assert 4 * wsize > dcn_bwd.BWD_SCRATCH_CAP and plan["slabs"] == 1 and plan["dw_partial_bytes"] == 0
    frags = 0 if kind == "dw" else 2 * wsize if dtype == torch.float32 else 9 * R50_C * 16 * 8
    coord = (plan["grid_z"] * 8 * R50_H * R50_H * 27
             if kind in ("fused", "dcoord") and plan["grid_z"] > 1 else 0)
    assert plan["scratch_floats"] == frags + coord
    assert plan["coord_partial_bytes"] == 4 * coord
