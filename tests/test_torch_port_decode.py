"""The PyTorch package's decode against the JAX package's, on the CPU.

Synthetic head maps with planted objects (built like `tests/test_decode.py`
builds them) plus small seed-made noise on every map, so that no two values
tie: one planted object alone would leave 99 of the K=100 slots tied on the
background, and the two frameworks order ties differently. The same numpy
maps go through both decodes. Integer-valued outputs must be equal, floats
within 1e-4 (sigmoid / sqrt / division in two libraries).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from centerpose_tpu.ops import decode as jax_decode
from centerpose_tpu_torch.ops import decode

H, W, J = 48, 64, 8   # ~H*W/9 local maxima of the noise: well over K = 100
ATOL = 1e-4


def _gaussian_map(h, w, cx, cy, sigma=1.5, peak=1.0):
    ys, xs = np.mgrid[0:h, 0:w]
    return peak * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))


def _logit(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


def make_outputs(seed=0, batch=2, extra_heads=False):
    """Two planted objects per image + distinct background noise."""
    rng = np.random.RandomState(seed)
    hm = np.zeros((batch, H, W, 1), np.float32)
    hm_hp = np.zeros((batch, H, W, J), np.float32)
    hps = rng.randn(batch, H, W, 2 * J).astype(np.float32) * 0.5
    wh = np.abs(rng.randn(batch, H, W, 2)).astype(np.float32) * 2 + 1
    reg = rng.rand(batch, H, W, 2).astype(np.float32) * 0.5
    hp_offset = rng.rand(batch, H, W, 2).astype(np.float32) * 0.5
    scale = np.abs(rng.randn(batch, H, W, 3)).astype(np.float32) + 0.5
    for b in range(batch):
        for n, (cx, cy) in enumerate([(14 + 3 * b, 15), (40, 30 - 2 * b)]):
            peak = 0.9 - 0.15 * n
            hm[b, :, :, 0] = np.maximum(hm[b, :, :, 0], _gaussian_map(H, W, cx, cy, peak=peak))
            offs = rng.randint(-6, 7, size=(J, 2)).astype(np.float32)
            wh[b, cy, cx] = [20.0, 18.0]
            for jj in range(J):
                kx, ky = cx + offs[jj, 0], cy + offs[jj, 1]
                hm_hp[b, :, :, jj] = np.maximum(
                    hm_hp[b, :, :, jj],
                    _gaussian_map(H, W, kx, ky, peak=peak - 0.01 * jj),  # distinct per joint
                )
                hps[b, cy, cx, 2 * jj:2 * jj + 2] = offs[jj] + rng.randn(2) * 0.3
    # Background: distinct values well below the planted peaks, above and
    # below the 0.1 keypoint threshold.
    # Evenly spaced levels, shuffled: neighbours differ by ~1e-5, far more than
    # the rounding of logit -> sigmoid in either library, so the order is firm.
    def background(shape):
        n = int(np.prod(shape))
        return (rng.permutation(n).reshape(shape) + 1.0) / n * 0.2

    hm = np.maximum(hm, background(hm.shape)).astype(np.float32)
    hm_hp = np.maximum(hm_hp, background(hm_hp.shape)).astype(np.float32)
    out = {
        "hm": _logit(hm).astype(np.float32),
        "hm_hp": _logit(hm_hp).astype(np.float32),
        "hps": hps, "wh": wh, "reg": reg, "hp_offset": hp_offset, "scale": scale,
    }
    if extra_heads:
        out["hps_uncertainty"] = rng.randn(batch, H, W, 2 * J).astype(np.float32)
        out["scale_uncertainty"] = rng.randn(batch, H, W, 3).astype(np.float32)
        out["tracking"] = rng.randn(batch, H, W, 2).astype(np.float32)
        out["tracking_hp"] = rng.randn(batch, H, W, 2 * J).astype(np.float32)
    return out


def _decode_both(outputs, **kw):
    ref = jax_decode.object_pose_decode(
        {k: jnp.asarray(v) for k, v in outputs.items()}, **kw
    )
    out = decode.object_pose_decode(
        {k: torch.from_numpy(v) for k, v in outputs.items()}, **kw
    )
    return out, {k: np.asarray(v) for k, v in ref.items()}


def _assert_dets_match(out, ref):
    assert set(out) == set(ref)
    for key, r in ref.items():
        o = out[key].numpy()
        assert o.shape == r.shape, key
        assert o.dtype == np.float32, key
        if key == "clses":
            np.testing.assert_array_equal(o, r, err_msg=key)
        else:
            np.testing.assert_allclose(o, r, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("fit_gaussian", [True, False])
def test_object_pose_decode_matches_jax(fit_gaussian):
    outputs = make_outputs(0)
    out, ref = _decode_both(
        outputs, k=100, rep_mode=1, fit_gaussian=fit_gaussian,
        balance_coefficient=2.0, hm_hp_thresh=0.1,
    )
    _assert_dets_match(out, ref)
    assert out["scores"].shape == (2, 100, 1) and out["kps"].shape == (2, 100, 16)
    # The planted objects come first and carry heatmap-refined keypoints.
    assert float(out["scores"][0, 0, 0]) == pytest.approx(0.9, abs=1e-3)
    assert (out["kps_heatmap_mean"][:, 0] > -5000).any()


@pytest.mark.parametrize(
    "kw",
    [
        dict(rep_mode=3), dict(rep_mode=4), dict(inference=False),
        dict(k=20, hm_hp_thresh=0.3), dict(apply_sigmoid=False),
    ],
    ids=["rep3", "rep4", "train_mode", "k20", "no_sigmoid"],
)
def test_object_pose_decode_options_match_jax(kw):
    outputs = make_outputs(1, extra_heads=True)
    if kw.get("apply_sigmoid") is False:
        for name in ("hm", "hm_hp"):
            outputs[name] = (1 / (1 + np.exp(-outputs[name]))).astype(np.float32)
    out, ref = _decode_both(outputs, **kw)
    _assert_dets_match(out, ref)


def test_decode_without_optional_heads_matches_jax():
    outputs = make_outputs(2)
    for name in ("reg", "wh", "hp_offset", "scale"):
        del outputs[name]
    out, ref = _decode_both(outputs, k=50)
    _assert_dets_match(out, ref)
    only = {k: v for k, v in outputs.items() if k in ("hm", "hps")}
    out, ref = _decode_both(only, k=50)
    _assert_dets_match(out, ref)


def test_primitives_match_jax():
    outputs = make_outputs(3)
    heat_np = (1 / (1 + np.exp(-outputs["hm_hp"].astype(np.float64)))).astype(np.float32)
    heat_t, heat_j = torch.from_numpy(heat_np), jnp.asarray(heat_np)
    np.testing.assert_allclose(
        decode.sigmoid_clamped(torch.from_numpy(outputs["hm"] * 5)).numpy(),
        np.asarray(jax_decode.sigmoid_clamped(jnp.asarray(outputs["hm"] * 5))),
        atol=1e-6,
    )
    nms_t = decode.heat_nms(heat_t)
    np.testing.assert_array_equal(nms_t.numpy(), np.asarray(jax_decode.heat_nms(heat_j)))
    # Index outputs are compared exactly: the noise makes every value distinct.
    for o, r in zip(decode.topk(nms_t, 30), jax_decode.topk(jnp.asarray(nms_t.numpy()), 30)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(decode.topk_channel(nms_t, 30),
                    jax_decode.topk_channel(jnp.asarray(nms_t.numpy()), 30)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    ind = np.random.RandomState(0).randint(0, H * W, (2, 17))
    np.testing.assert_array_equal(
        decode.gather_feat(heat_t, torch.from_numpy(ind)).numpy(),
        np.asarray(jax_decode.gather_feat(heat_j, jnp.asarray(ind))),
    )
    windows = np.random.RandomState(1).rand(2, 3, 5, 11, 11).astype(np.float32)
    for o, r in zip(
        decode._batched_gaussian_moments(torch.from_numpy(windows)),
        jax_decode._batched_gaussian_moments(jnp.asarray(windows)),
    ):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_decode_takes_bfloat16_maps():
    """Head maps of a bf16 network are decoded in float32."""
    outputs = make_outputs(4)
    out = decode.object_pose_decode(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in outputs.items()}
    )
    assert all(v.dtype == torch.float32 for v in out.values())
    assert all(torch.isfinite(v).all() for v in out.values())
