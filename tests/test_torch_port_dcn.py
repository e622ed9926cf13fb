"""The PyTorch package's plain DCNv2 against the JAX package's, on the CPU.

Same numpy-made inputs go through `centerpose_tpu.ops.dcn.dcn_v2`, through the
interpret-mode Pallas path `dcn_v2_onehot(exact=False)` (the function that
reaches `_grouped_kernel`, the TPU kernel the CUDA kernel replaces) and through
`centerpose_tpu_torch.ops.dcn.dcn_v2`. All float32; tolerances are absolute and
cover the different summation order of the two frameworks' matrix products.
The CUDA kernel itself cannot run here: `chip_smoke.py` holds it against the
plain version on the GPU.
"""

import numpy as np
import pytest
from unittest import mock

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import centerpose_tpu.ops.dcn_onehot as oh
from centerpose_tpu.ops.dcn import dcn_v2 as jax_dcn_v2
from centerpose_tpu_torch.ops.dcn import dcn_v2
from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward

ATOL = 2e-5  # f32; products of up to 9*C terms summed in a different order

_ORIG_PALLAS_CALL = pl.pallas_call


def _interp(*a, **k):
    if jax.default_backend() == "cpu":
        k["interpret"] = True
    return _ORIG_PALLAS_CALL(*a, **k)


def _rand_case(seed, b, h, w, c, co, off_scale):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    offset = (rng.rand(b, h, w, 18).astype(np.float32) * 2 - 1) * off_scale
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    wt = rng.randn(3, 3, c, co).astype(np.float32) * 0.1
    bias = rng.randn(co).astype(np.float32)
    return [x, offset, mask, wt, bias]


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _both(args):
    ref = np.asarray(jax_dcn_v2(*[jnp.asarray(a) for a in args]))
    out = dcn_v2(*_torch(args)).numpy()
    return out, ref


@pytest.mark.parametrize(
    "b,h,w,c,co,scale",
    [
        (1, 16, 16, 4, 4, 0.0),    # zero offsets == plain conv
        (2, 16, 32, 8, 16, 1.8),   # general offsets
        (1, 24, 16, 8, 8, 2.8),
        (1, 16, 16, 4, 8, 1.9),    # c != co
        (2, 9, 13, 8, 24, 3.0),    # odd map sizes
    ],
)
def test_plain_matches_jax_gather(b, h, w, c, co, scale):
    out, ref = _both(_rand_case(0, b, h, w, c, co, scale))
    assert out.shape == ref.shape == (b, h, w, co)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def _special_offsets(kind, b, h, w):
    off = np.zeros((b, h, w, 18), np.float32)
    if kind == "boundary":
        # Samples pushed across every image edge: outside corners count 0.
        off[:, :2, :, 0::2] = -2.5
        off[:, -2:, :, 0::2] = 2.5
        off[:, :, :2, 1::2] = -2.5
        off[:, :, -2:, 1::2] = 2.5
    elif kind == "all_off_image":
        off[..., 0::2] = -(h + 5.25)
        off[..., 1::2] = w + 7.5
    elif kind == "integer":
        off[:] = np.random.RandomState(3).randint(-3, 4, off.shape)
    elif kind == "dy10":
        rng = np.random.RandomState(4)
        off[..., 0::2] = (rng.rand(b, h, w, 9) * 2 - 1) * 10.0
        off[..., 1::2] = (rng.rand(b, h, w, 9) * 2 - 1) * 2.0
    elif kind == "huge":
        off[..., 0::2] = 3e9   # would overflow an int cast if not handled
        off[..., 1::2] = -3e9
    return off


@pytest.mark.parametrize(
    "kind", ["boundary", "all_off_image", "integer", "dy10", "huge"]
)
def test_plain_matches_jax_special_offsets(kind):
    b, h, w, c, co = 2, 16, 16, 8, 16
    args = _rand_case(1, b, h, w, c, co, 0.0)
    args[1] = _special_offsets(kind, b, h, w)
    out, ref = _both(args)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)
    if kind in ("all_off_image", "huge"):
        # Every sample is outside: only the bias is left.
        np.testing.assert_allclose(
            out, np.broadcast_to(args[4], out.shape), atol=1e-6
        )


def test_zero_offsets_unit_mask_is_plain_conv():
    x, offset, mask, wt, bias = _rand_case(2, 2, 12, 10, 8, 16, 0.0)
    mask[:] = 1.0
    out = dcn_v2(*_torch([x, offset, mask, wt, bias]))
    ref = F.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(wt).permute(3, 2, 0, 1),       # HWIO -> OIHW
        torch.from_numpy(bias), padding=1,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize(
    "b,h,w,c,co", [(1, 16, 16, 8, 8), (2, 16, 32, 8, 16)]
)
def test_plain_matches_pallas_grouped_kernel(b, h, w, c, co):
    """Against the TPU kernel's own function in interpret mode, as the JAX
    package's tests run it on the CPU."""
    args = _rand_case(5, b, h, w, c, co, 2.5)
    with mock.patch.object(pl, "pallas_call", _interp):
        ref = np.asarray(
            oh.dcn_v2_onehot(*[jnp.asarray(a) for a in args], 4, False)
        )
    out = dcn_v2(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version; no kernel launch is counted."""
    args = _torch(_rand_case(6, 1, 8, 8, 8, 8, 1.5))
    before = dcn_v2_forward.launches
    out = dcn_v2_forward(*args)
    assert dcn_v2_forward.launches == before
    assert torch.equal(out, dcn_v2(*args))
    # A channel slice of one wider NHWC tensor is what the network passes.
    om = torch.randn(1, 8, 8, 27)
    out2 = dcn_v2_forward(args[0], om[..., :18], torch.sigmoid(om[..., 18:]), args[3], args[4])
    assert out2.shape == (1, 8, 8, 8) and torch.isfinite(out2).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_is_the_hwio_weight(dtype):
    """`kernel_weight` gives the same HWIO values whatever memory layout the
    kernel of the type reads: float32 contiguous HWIO ([9C, Co] rows),
    bfloat16 a view of a contiguous [Co, 3, 3, C] tensor ([Co, 9C] rows)."""
    from centerpose_tpu_torch.ops.dcn_fwd import kernel_weight

    args = [a.to(dtype) for a in _torch(_rand_case(11, 1, 6, 6, 8, 16, 1.5))]
    oihw = args[3].permute(3, 2, 0, 1).contiguous()
    hwio = kernel_weight(oihw)
    assert hwio.shape == args[3].shape and torch.equal(hwio, args[3])
    if dtype == torch.bfloat16:
        assert hwio.permute(3, 0, 1, 2).is_contiguous()
    else:
        assert hwio.is_contiguous()
    assert torch.equal(dcn_v2_forward(*args[:3], hwio, args[4]), dcn_v2(*args))


def test_dcn_module_keeps_one_copy_of_its_weight():
    """The module lays its weight out for the kernel once, again after the
    parameter is written to or cast, and hands autograd the parameter itself."""
    from centerpose_tpu_torch.models.layers import DCN

    torch.manual_seed(0)
    mod = DCN(8, 16)
    x = torch.randn(1, 8, 6, 6)
    with torch.no_grad():
        w1 = mod.operands(x)[3]
        assert mod.operands(x)[3] is w1
        assert torch.equal(w1, mod.weight.permute(2, 3, 1, 0))
        mod.weight.mul_(2.0)
        w2 = mod.operands(x)[3]
        assert w2 is not w1 and torch.equal(w2, mod.weight.permute(2, 3, 1, 0))
        mod.to(torch.bfloat16)
        w3 = mod.operands(x.to(torch.bfloat16))[3]
        assert w3.dtype == torch.bfloat16 and w3.permute(3, 0, 1, 2).is_contiguous()
        mod.to(torch.float32)
    assert "_hwio" not in mod.state_dict() and len(mod.state_dict()) == 4
    mod(x).sum().backward()
    assert mod.weight.grad is not None and mod.weight.grad.abs().sum() > 0


def test_plain_bfloat16_close_to_float32():
    """bf16 operands: float32 coordinates and blend, one rounding of the
    columns and one of the output — within 3e-2 of the output's range."""
    args = _torch(_rand_case(7, 1, 12, 12, 16, 16, 2.0))
    ref = dcn_v2(*args)
    out = dcn_v2(*[a.to(torch.bfloat16) for a in args])
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref).abs().max().item()
    assert err <= 3e-2 * ref.abs().max().item()


def test_plain_is_differentiable():
    args = _torch(_rand_case(8, 1, 6, 6, 8, 8, 1.2))
    for a in args:
        a.requires_grad_(True)
    dcn_v2(*args).square().sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)
    assert args[1].grad.abs().sum() > 0


def test_pixel_stride_check():
    """What the kernel's wrapper accepts for offset / mask: NHWC with evenly
    spaced pixels (a channel slice of a wider tensor), nothing else."""
    from centerpose_tpu_torch.ops.dcn_fwd import _pixel_stride

    om = torch.zeros(2, 4, 5, 27)
    assert _pixel_stride(om[..., :18], "offset") == 27
    assert _pixel_stride(om[..., 18:], "mask") == 27
    assert _pixel_stride(torch.zeros(2, 4, 5, 9), "mask") == 9
    assert _pixel_stride(torch.zeros(1, 1, 1, 9), "mask") == 9
    with pytest.raises(ValueError):
        _pixel_stride(om.permute(0, 2, 1, 3)[..., :18], "offset")   # W and H swapped
    with pytest.raises(ValueError):
        _pixel_stride(om[..., 0:18:2], "offset")                    # channel stride 2


def test_wrapper_refuses_mixed_devices_and_meta_tensors():
    args = _torch(_rand_case(9, 1, 4, 4, 8, 8, 1.0))
    with pytest.raises(ValueError):
        dcn_v2_forward(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError):
        dcn_v2_forward(*[a.to("meta") for a in args])   # neither CPU nor CUDA


def test_build_module_names_sources_and_fails_without_nvcc(monkeypatch, tmp_path):
    """The library is keyed on the sources and the flags; without a compiler
    the build raises (there is no fallback)."""
    from centerpose_tpu_torch import _build

    assert _build.sources() == ["dcn_v2_fwd"]
    path = _build.library_path("dcn_v2_fwd")
    assert path.parent == _build.BUILD and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX"])
    assert _build.library_path("dcn_v2_fwd") != path
    assert any("sm_90a" in f for f in _build.NVCC_FLAGS)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
