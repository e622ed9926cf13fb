"""The PyTorch package's DCNv2 gradients against the JAX package's, on the CPU.

The same numpy inputs go through `jax.vjp(centerpose_tpu.ops.dcn.dcn_v2)`,
through the JAX package's Pallas backward `dcn_v2_grads` (fused and split, in
interpret mode as its own tests run it on the CPU) and through the plain
versions of `centerpose_tpu_torch.ops.dcn_bwd`, which are what the CUDA
kernels are held against on the card by `chip_smoke.py`. float32;
rtol = atol = 2e-4, the JAX package's own bound for these gradients
(`tests/test_dcn_bwd.py`): sums of up to 9*C*Co and B*H*W terms in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from centerpose_tpu.ops.dcn import dcn_v2 as jax_dcn_v2
from centerpose_tpu.ops.dcn_bwd import dcn_bwd_supported
from centerpose_tpu.ops.dcn_bwd import dcn_v2_grads as jax_dcn_v2_grads
from centerpose_tpu_torch.models.layers import DCN
from centerpose_tpu_torch.ops import dcn_bwd
from centerpose_tpu_torch.ops.dcn import dcn_v2
from centerpose_tpu_torch.ops.dcn_fwd import DCNv2Function, dcn_v2_forward

NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")
TOL = dict(rtol=2e-4, atol=2e-4)

# The case list of the JAX package's tests/test_dcn_bwd.py.
CASES = [
    (2, 8, 16, 8, 8, 0.9, False),       # generic small offsets
    (1, 16, 16, 8, 16, 3.5, False),     # multi-row windows, C != Co
    (2, 8, 16, 8, 8, 25.0, False),      # most samples fully off-image
    (2, 8, 16, 8, 8, 0.0, True),        # integer offsets (the at-init case)
    (1, 8, 16, 32, 8, 1.1, False),      # C > W
    (1, 8, 16, 32, 8, 25.0, False),     # C > W, mostly off-image
    (1, 8, 16, 32, 8, 0.0, True),       # C > W, integer offsets
    (1, 32, 8, 32, 8, 3.5, False),      # C > W, tall map
]


def make_inputs(seed, b, h, w, c, co, off_scale, integer):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    if integer:
        off = rng.randint(-2, 3, size=(b, h, w, 18)).astype(np.float32)
    else:
        off = off_scale * rng.randn(b, h, w, 18).astype(np.float32)
        # Strictly away from integer coordinates: the JAX autodiff oracle's
        # subgradient choice at exact ties is its own.
        frac = off - np.floor(off)
        off = (np.floor(off) + np.clip(frac, 0.07, 0.93)).astype(np.float32)
    m = rng.rand(b, h, w, 9).astype(np.float32)
    wt = (0.3 * rng.randn(3, 3, c, co)).astype(np.float32)
    bi = (0.1 * rng.randn(co)).astype(np.float32)
    g = rng.randn(b, h, w, co).astype(np.float32)
    return x, off, m, wt, bi, g


def to_torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def jax_vjp(args):
    *primals, g = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: jax_dcn_v2(*a, stride=1, padding=1, dilation=1), *primals)
    return [np.asarray(t) for t in vjp(g)]


def assert_terms(got, ref, **tol):
    assert len(got) == len(ref) == 5
    for name, a, r in zip(NAMES, got, ref):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == np.asarray(r).shape, name
        np.testing.assert_allclose(a, np.asarray(r), err_msg=name, **(tol or TOL))


@pytest.mark.parametrize("b,h,w,c,co,off_scale,integer", CASES)
def test_plain_grads_match_jax_vjp(b, h, w, c, co, off_scale, integer):
    """All five terms against `jax.vjp(dcn_v2)`, integer offsets included:
    both autodiffs differentiate `py - floor(py)` with slope 1, which is the
    one-sided corner difference."""
    args = make_inputs(hash((b, h, w, c, co)) % 2**31, b, h, w, c, co, off_scale, integer)
    got = dcn_bwd.dcn_v2_grads_plain(*to_torch(args))
    assert_terms(got, jax_vjp(args))
    if integer:
        assert float(got[1].abs().max()) > 1e-2


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,w,c,co,off_scale,integer", CASES)
def test_plain_grads_match_jax_pallas_backward(b, h, w, c, co, off_scale, integer, fused):
    """All five terms against the TPU kernels' own function in interpret
    mode: `_fused_kernel` (fused) and `_dx/_dcoord/_dw_kernel` (split). This
    is where the integer-offset rule is held: d_offset is the one-sided
    corner difference there, and it is not 0."""
    assert dcn_bwd_supported((b, h, w, c), (3, 3, c, co)) > 0
    args = make_inputs(hash((b, h, w, c, co)) % 2**31, b, h, w, c, co, off_scale, integer)
    ref = jax_dcn_v2_grads(*[jnp.asarray(a) for a in args], fused=fused)
    t = to_torch(args)
    got = dcn_bwd.dcn_v2_grads(*t, fused=fused)       # CPU tensors: the plain versions
    assert_terms(got, ref)
    if integer:
        assert float(got[1].abs().max()) > 1e-2


def test_zero_offsets_unit_mask_equal_conv2d_grads():
    """offset == 0 and mask == 1: the gradients are a plain 3x3 conv's."""
    x, _, _, wt, bi, g = to_torch(make_inputs(0, 2, 8, 16, 8, 8, 0.0, False))
    off = torch.zeros(2, 8, 16, 18)
    m = torch.ones(2, 8, 16, 9)
    dx, _, _, dw, db = dcn_bwd.dcn_v2_grads(x, off, m, wt, bi, g)
    xc = x.permute(0, 3, 1, 2).clone().requires_grad_(True)
    wc = wt.permute(3, 2, 0, 1).clone().requires_grad_(True)
    bc = bi.clone().requires_grad_(True)
    F.conv2d(xc, wc, bc, padding=1).backward(g.permute(0, 3, 1, 2))
    np.testing.assert_allclose(dx.numpy(), xc.grad.permute(0, 2, 3, 1).numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), wc.grad.permute(2, 3, 1, 0).numpy(), **TOL)
    np.testing.assert_allclose(db.numpy(), bc.grad.numpy(), **TOL)


def test_per_term_plain_functions_equal_the_slices():
    args = to_torch(make_inputs(5, 2, 8, 12, 8, 16, 1.5, False))
    x, off, m, wt, bi, g = args
    dx, doff, dm, dw, db = dcn_bwd.dcn_v2_grads_plain(*args)
    assert torch.equal(dcn_bwd.dcn_v2_dx_plain(x, off, m, wt, g), dx)
    doff2, dm2 = dcn_bwd.dcn_v2_dcoord_plain(x, off, m, wt, g)
    assert torch.equal(doff2, doff) and torch.equal(dm2, dm)
    assert torch.equal(dcn_bwd.dcn_v2_dw_plain(x, off, m, wt, g), dw)
    assert torch.equal(db, g.sum(dim=(0, 1, 2)))
    # The four kernel wrappers take their plain versions for CPU tensors and
    # count no launch.
    before = [f.launches for f in (dcn_bwd.dcn_v2_bwd_fused, dcn_bwd.dcn_v2_bwd_dx,
                                   dcn_bwd.dcn_v2_bwd_dcoord, dcn_bwd.dcn_v2_bwd_dw)]
    fused = dcn_bwd.dcn_v2_bwd_fused(x, off, m, wt, g)
    assert all(torch.equal(a, r) for a, r in zip(fused, (dx, doff, dm, dw)))
    assert torch.equal(dcn_bwd.dcn_v2_bwd_dx(x, off, m, wt, g), dx)
    assert torch.equal(dcn_bwd.dcn_v2_bwd_dcoord(x, off, m, wt, g)[0], doff)
    assert torch.equal(dcn_bwd.dcn_v2_bwd_dw(x, off, m, wt, g), dw)
    after = [f.launches for f in (dcn_bwd.dcn_v2_bwd_fused, dcn_bwd.dcn_v2_bwd_dx,
                                  dcn_bwd.dcn_v2_bwd_dcoord, dcn_bwd.dcn_v2_bwd_dw)]
    assert before == after


def test_grads_take_the_networks_operand_layouts():
    """offset and mask as channel slices of one 27-channel tensor, the weight
    as a permuted view of an OIHW parameter, dout non-contiguous: the same
    numbers as with contiguous operands."""
    x, off, m, wt, bi, g = to_torch(make_inputs(6, 1, 8, 8, 8, 16, 1.2, False))
    om = torch.cat([off, m], dim=-1)
    oihw = wt.permute(3, 2, 0, 1).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    got = dcn_bwd.dcn_v2_grads(
        x, om[..., :18], om[..., 18:], oihw.permute(2, 3, 1, 0), bi, g_nchw.permute(0, 2, 3, 1)
    )
    ref = dcn_bwd.dcn_v2_grads(x, off, m, wt, bi, g)
    for name, a, r in zip(NAMES, got, ref):
        assert a.is_contiguous(), name
        # Same sums over another memory order: float32 rounding only.
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_function_route_on_cpu_is_autograd_of_the_plain_version():
    """`dcn_v2_forward` on CPU tensors that require grad: ordinary autograd
    through `dcn_v2` (no `DCNv2Function`, no launch), and the same gradients
    as `dcn_v2_grads_plain`."""
    args = to_torch(make_inputs(7, 1, 8, 8, 8, 8, 1.3, False))
    g = args.pop()
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = dcn_v2_forward(*leaves)
    assert out.grad_fn is not None and "DCNv2Function" not in type(out.grad_fn).__name__
    assert torch.equal(out, dcn_v2(*args))
    out.backward(g)
    ref = dcn_bwd.dcn_v2_grads_plain(*args, g)
    for name, leaf, r in zip(NAMES, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r.numpy(), atol=1e-6, err_msg=name)


def test_function_backward_honours_needs_input_grad(monkeypatch):
    """`DCNv2Function.backward` off the card: with the forward launch stubbed
    by the plain version, the backward goes through the `dcn_v2_bwd_*`
    wrappers (plain versions on CPU tensors), returns the gradients of
    autograd, chooses the fused kernel when every term is asked for, and only
    the kernels of the terms asked for when an operand is frozen."""
    from centerpose_tpu_torch.ops import dcn_fwd

    monkeypatch.setattr(dcn_fwd, "_launch_forward", lambda *a: dcn_v2(*a))
    called = []
    for name in ("dcn_v2_bwd_fused", "dcn_v2_bwd_dx", "dcn_v2_bwd_dcoord", "dcn_v2_bwd_dw"):
        real = getattr(dcn_bwd, name)
        monkeypatch.setattr(
            dcn_bwd, name,
            lambda *a, _real=real, _name=name: (called.append(_name), _real(*a))[1],
        )
    args = to_torch(make_inputs(8, 1, 6, 8, 8, 8, 1.1, False))
    g = args.pop()
    ref = dcn_bwd.dcn_v2_grads_plain(*args, g)

    leaves = [a.clone().requires_grad_(True) for a in args]
    DCNv2Function.apply(*leaves).backward(g)
    assert called == ["dcn_v2_bwd_fused"]
    for name, leaf, r in zip(NAMES, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r.numpy(), atol=1e-6, err_msg=name)

    called.clear()                                   # frozen weight and bias
    leaves = [a.clone().requires_grad_(i < 3) for i, a in enumerate(args)]
    DCNv2Function.apply(*leaves).backward(g)
    assert called == ["dcn_v2_bwd_dx", "dcn_v2_bwd_dcoord"]
    assert leaves[3].grad is None and leaves[4].grad is None
    np.testing.assert_allclose(leaves[1].grad.numpy(), ref[1].numpy(), atol=1e-6)

    called.clear()                                   # only the weight trains
    leaves = [a.clone().requires_grad_(i == 3) for i, a in enumerate(args)]
    DCNv2Function.apply(*leaves).backward(g)
    assert called == ["dcn_v2_bwd_dw"]
    np.testing.assert_allclose(leaves[3].grad.numpy(), ref[3].numpy(), atol=1e-6)


def test_dcn_module_trains_its_offset_conv_from_zero():
    """A fresh block has a zero offset conv: every sample sits on an integer
    coordinate, and the offset conv still gets a gradient (the one-sided
    corner difference)."""
    torch.manual_seed(0)
    mod = DCN(8, 8)
    assert float(mod.conv_offset_mask.weight.detach().abs().max()) == 0.0
    mod(torch.randn(2, 8, 6, 6)).square().sum().backward()
    g = mod.conv_offset_mask.weight.grad
    assert g is not None and float(g[:18].abs().max()) > 1e-3      # the 18 offset channels
    assert float(g[18:].abs().max()) > 1e-3                        # the 9 mask channels


def _meta(args):
    return [a.to("meta") for a in args]


def test_wrapper_argument_checks():
    """What the kernels' wrappers refuse before any launch (the CPU-reachable
    part: the checks run on shapes, types and strides only)."""
    x, off, m, wt, bi, g = to_torch(make_inputs(9, 1, 4, 4, 8, 8, 1.0, False))
    with pytest.raises(ValueError, match="different devices"):
        dcn_bwd.dcn_v2_grads(x.to("meta"), off, m, wt, bi, g)
    with pytest.raises(ValueError, match="unsupported device"):
        dcn_bwd.dcn_v2_grads(*_meta([x, off, m, wt, bi, g]))
    launch = dcn_bwd._launch
    with pytest.raises(TypeError, match="float32"):
        launch("fused", x.bfloat16(), off, m, wt, g)
    with pytest.raises(ValueError, match=r"expected \[3,3,C,Co\]"):
        launch("fused", x, off, m, wt.reshape(9, 8, 8), g)
    with pytest.raises(ValueError, match="channels"):
        launch("fused", x, off, m, wt, g[..., :4])
    with pytest.raises(ValueError, match="x "):
        launch("fused", x[:, :2], off, m, wt, g)
    with pytest.raises(ValueError, match="offset"):
        launch("dcoord", x, off[..., :16], m, wt, g)
    with pytest.raises(ValueError, match="multiples of 8"):
        launch("dw", x[..., :4], off, m, wt[:, :, :4], g)
    with pytest.raises(ValueError, match="contiguous"):
        launch("fused", x.permute(0, 2, 1, 3), off, m, wt, g)
    with pytest.raises(ValueError, match="evenly spaced"):
        launch("dx", None, off.permute(0, 2, 1, 3), m, wt, g)
    assert dcn_bwd.pixel_stride(torch.zeros(2, 4, 5, 27)[..., :18], "offset", "t") == 27


def test_build_knows_the_backward_source():
    from centerpose_tpu_torch import _build

    assert "dcn_v2_bwd" in _build.sources()
    src = (_build.CSRC / "dcn_v2_bwd.cu").read_text()
    for kernel in dcn_bwd._KERNELS:
        assert f'extern "C" int dcn_v2_bwd_{kernel}_launch' in src
    # The products are the kernels' own: no library call in the source.
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
