"""The PyTorch package's training losses against the JAX package's, on the CPU.

The same numpy predictions and targets go through every loss function of
`centerpose_tpu.training.losses` and its counterpart in
`centerpose_tpu_torch.training.losses`, on the cases of `tests/test_losses.py`.
float32, atol 1e-5 (elementwise arithmetic and short sums; `exp`/`log` of the
two libraries differ in the last bit); the KLD uncertainty losses 1e-4 (their
`exp(-a / 0.01) / var` terms carry values of a few hundred). Gradients of the
total with respect to the head maps: atol 1e-5, rtol 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.data.targets import ObjectAnnotation as JaxAnnotation
from centerpose_tpu.data.targets import render_targets as jax_render_targets
from centerpose_tpu.data.targets import stack_batch as jax_stack_batch
from centerpose_tpu.training import losses as jl
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.training import losses as tl
from centerpose_tpu_torch.training.trainer import loss_config_from

B, S, H, W, M = 2, 2, 16, 16, 4
ATOL = 1e-5


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-5)


def _focal_cases():
    rng = np.random.RandomState(0)
    gt = np.zeros((2, 2, H, W, 3), np.float32)
    gt[0, 0, 5, 5, 0] = 1.0
    gt[0, 1, 10, 10, 1] = 1.0
    gt[0, 0, 5, 6, 0] = 0.8           # a gaussian shoulder: down-weighted negative
    # sample 1 has no positive at all: the num_pos == 0 branch
    pred = np.clip(rng.rand(2, H, W, 3), 1e-4, 1 - 1e-4).astype(np.float32)
    return pred, gt


def test_focal_loss_matches():
    pred, gt = _focal_cases()
    ref = jl.focal_loss(J(pred), J(gt))
    got = tl.focal_loss(T(pred), T(gt))
    assert got.shape == (2, 2)
    close(got, ref)
    assert float(got[1, 0]) > 0        # no positives: the negative term alone


def _reg_setup(d=2, seed=0):
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, H, W, d).astype(np.float32)
    ind = rng.randint(0, H * W, size=(B, S, M))
    mask = (rng.rand(B, S, M) > 0.3).astype(np.float32)
    target = rng.randn(B, S, M, d).astype(np.float32)
    target[0, 0, 0] = 0.0              # relative mode: the target == 0 guard
    return feat, ind, mask, target


def test_gather_by_ind_matches():
    feat, ind, _, _ = _reg_setup()
    close(tl.gather_by_ind(T(feat), T(ind)), jl.gather_by_ind(J(feat), J(ind)), atol=0)


@pytest.mark.parametrize("relative,ref_dims", [(False, None), (True, None), (False, (0.78, 1.0, 0.77))])
def test_reg_l1_loss_matches(relative, ref_dims):
    feat, ind, mask, target = _reg_setup(d=3)
    ref = jl.reg_l1_loss(J(feat), J(mask), J(ind), J(target), relative=relative, dimension_ref=ref_dims)
    got = tl.reg_l1_loss(T(feat), T(mask), T(ind), T(target), relative=relative, dimension_ref=ref_dims)
    # The relative mode divides by 1e-6 where the target is 0: compare at that scale.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=ATOL)


def test_reg_weighted_l1_loss_matches():
    feat, ind, _, target = _reg_setup(d=2)
    mask4 = (np.random.RandomState(3).rand(B, S, M, 2) > 0.5).astype(np.float32)
    ref = jl.reg_weighted_l1_loss(J(feat), J(mask4), J(ind), J(target))
    close(tl.reg_weighted_l1_loss(T(feat), T(mask4), T(ind), T(target)), ref)


def test_kld_losses_match():
    feat, ind, mask, target = _reg_setup(d=2)
    unc = (0.3 * np.random.RandomState(4).randn(B, H, W, 2)).astype(np.float32)
    ref = jl.kld_scale_loss(J(feat), J(unc), J(mask), J(ind), J(target), 0.01)
    close(tl.kld_scale_loss(T(feat), T(unc), T(mask), T(ind), T(target), 0.01), ref, atol=1e-4)
    mask4 = (np.random.RandomState(5).rand(B, S, M, 2) > 0.5).astype(np.float32)
    ref = jl.kld_keypoint_loss(J(feat), J(unc), J(mask4), J(ind), J(target), 0.01)
    close(tl.kld_keypoint_loss(T(feat), T(unc), T(mask4), T(ind), T(target), 0.01), ref, atol=1e-4)


def batch_and_outputs(s=1, seed=0, **overrides):
    """The rendered batch and random head maps of `tests/test_losses.py`'s
    full-loss cases (all heads random here, so that every term is live)."""
    cfg = jax_preset("centerpose", input_h=64, input_w=64, num_symmetry=s, **overrides)
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(2):
        obj = JaxAnnotation(
            center=np.array([8.0, 8.0]) + rng.uniform(-2, 2, 2),
            size=np.array([6.0, 6.0]),
            keypoints=rng.uniform(4, 12, size=(s, 8, 2)).astype(np.float32),
            keypoints_visible=np.ones((s, 8), bool),
            scale_3d=np.array([1.0, 0.7, 1.3], np.float32),
        )
        samples.append(jax_render_targets([obj], cfg))
    batch = jax_stack_batch(samples)
    outputs = {
        name: (0.5 * rng.randn(2, 16, 16, n)).astype(np.float32)
        for name, n in cfg.heads.items()
    }
    return cfg, batch, outputs


@pytest.mark.parametrize(
    "phase,s,overrides",
    [
        ("train", 1, {}),
        ("val", 1, {}),
        ("train", 2, {}),
        ("train", 1, dict(hps_uncertainty=True, obj_scale_uncertainty=True)),
        ("train", 1, dict(category="cup", use_residual=True, num_symmetry=1)),
    ],
)
def test_centerpose_loss_matches(phase, s, overrides):
    """loss, every entry of stats, the symmetry choice, and the gradient of
    the loss with respect to every head map."""
    overrides = dict(overrides)
    s = overrides.pop("num_symmetry", s)
    jcfg, batch, outputs = batch_and_outputs(s=s, **overrides)
    tcfg = preset("centerpose", input_h=64, input_w=64, num_symmetry=s, **overrides)
    jloss_cfg = jl.CenterPoseLossConfig(**{
        f.name: getattr(loss_config_from(tcfg), f.name)
        for f in jl.CenterPoseLossConfig.__dataclass_fields__.values()
    })
    jbatch = {k: J(v) for k, v in batch.items()}

    def jfn(outs):
        loss, stats, choice = jl.centerpose_loss(outs, jbatch, jloss_cfg, phase)
        return loss, (stats, choice)

    (jloss, (jstats, jchoice)), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: J(v) for k, v in outputs.items()}
    )

    touts = {k: T(v).requires_grad_(True) for k, v in outputs.items()}
    tbatch = {k: T(v) for k, v in batch.items()}
    loss, stats, choice = tl.centerpose_loss(touts, tbatch, loss_config_from(tcfg), phase)
    loss.backward()

    assert np.isfinite(loss.item())
    close(loss, jloss, atol=1e-5 if not overrides.get("hps_uncertainty") else 1e-4)
    assert set(stats) == set(jstats)
    for k in jstats:
        close(stats[k], jstats[k], atol=1e-5 if not overrides.get("hps_uncertainty") else 1e-4)
    assert choice.tolist() == np.asarray(jchoice).tolist()
    for k in outputs:
        g = touts[k].grad
        jg = np.asarray(jgrads[k])
        if g is None:                  # a head the phase's loss does not read
            assert np.abs(jg).max() == 0.0, k
            continue
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-5, rtol=1e-4, err_msg=k)


def test_symmetry_argmin_prefers_matching_copy():
    _, batch, outputs = batch_and_outputs(s=2)
    hps_t, ind = batch["hps"], batch["ind"]
    hps_map = np.zeros((2, 16, 16, 16), np.float32)
    hps_map[0].reshape(-1, 16)[ind[0, 1, 0]] = hps_t[0, 1, 0]
    outputs = dict(outputs, hps=hps_map)
    _, _, choice = tl.centerpose_loss(
        {k: T(v) for k, v in outputs.items()}, {k: T(v) for k, v in batch.items()},
        tl.CenterPoseLossConfig(), "train",
    )
    assert int(choice[0]) == 1


def test_loss_config_defaults_are_the_jax_packages():
    a, b = tl.CenterPoseLossConfig(), jl.CenterPoseLossConfig()
    assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
        f: getattr(b, f) for f in b.__dataclass_fields__
    }
