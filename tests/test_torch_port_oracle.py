"""The PyTorch package's oracle hooks (`training/oracle.py`) against the JAX
package's, on the CPU: `gen_oracle_map` on seeded values and seeds
(nearest-seed fill, an image without objects), and `apply_oracles` with
every oracle on NHWC outputs and a rendered batch, twins of
`tests/test_resnet_oracle.py::TestOracle` plus the JAX functions' results
on the same arrays."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.training import oracle as jax_oracle
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import targets
from centerpose_tpu_torch.training import oracle
from tests.test_torch_port_training import annotations


def test_gen_oracle_map_nearest_fill():
    values = np.zeros((1, 2, 2), np.float32)
    values[0, 0] = [1.0, 2.0]
    values[0, 1] = [5.0, 6.0]
    inds = np.array([[1 * 8 + 1, 6 * 8 + 6]])     # seeds at (1, 1) and (6, 6)
    out = oracle.gen_oracle_map(values, inds, 8, 8)
    np.testing.assert_allclose(out[0, 1, 1], [1, 2])
    np.testing.assert_allclose(out[0, 6, 6], [5, 6])
    np.testing.assert_allclose(out[0, 0, 0], [1, 2])
    np.testing.assert_allclose(out[0, 7, 7], [5, 6])


@pytest.mark.parametrize("seed", [0, 1])
def test_gen_oracle_map_matches_jax(seed):
    """Random seeds and vectors over a batch of 3, one image without any
    object, unused slots (ind 0): the same map, bit for bit."""
    rng = np.random.RandomState(seed)
    h, w = 12, 10
    values = rng.randn(3, 6, 4).astype(np.float32)
    inds = rng.randint(1, h * w, (3, 6))
    inds[0, 4:] = 0
    inds[1] = 0
    out = oracle.gen_oracle_map(values, inds, h, w)
    ref = jax_oracle.gen_oracle_map(values, inds, h, w)
    assert out.dtype == np.float32 and out.shape == (3, h, w, 4)
    np.testing.assert_array_equal(out, ref)
    assert np.abs(out[1]).max() == 0


def test_apply_oracle_hm():
    hm_gt = np.zeros((1, 1, 8, 8, 1), np.float32)
    hm_gt[0, 0, 3, 3, 0] = 1.0
    outputs = {"hm": torch.zeros((1, 8, 8, 1)), "hps": torch.zeros((1, 8, 8, 16))}
    out = oracle.apply_oracles(outputs, {"hm": torch.from_numpy(hm_gt)}, {"hm": True})
    rec = torch.sigmoid(out["hm"]).numpy()
    assert rec[0, 3, 3, 0] > 0.99 and rec[0, 0, 0, 0] < 0.01
    assert out["hps"] is outputs["hps"]


@pytest.mark.parametrize("symmetry_id", [0, 1])
def test_apply_oracles_matches_jax(symmetry_id):
    """Every oracle on a batch from `render_targets` (two symmetries of 2
    objects per image): heatmaps logit-inverted, keypoint and keypoint-offset
    maps filled from the nearest object; the others left as they are."""
    cfg = preset("centerpose_dla", input_h=64, input_w=64, num_symmetry=2)
    rng = np.random.RandomState(5)
    batch = targets.stack_batch([targets.render_targets(annotations(targets, cfg, rng, n_sym=2), cfg)
                                 for _ in range(2)])
    q = cfg.output_h
    outs = {k: rng.randn(2, q, q, c).astype(np.float32) for k, c in cfg.heads.items()}
    which = {"hm": True, "hm_hp": True, "kps": True, "hp_offset": True}
    ref = jax_oracle.apply_oracles({k: jnp.asarray(v) for k, v in outs.items()},
                                   {k: jnp.asarray(v) for k, v in batch.items()}, which, symmetry_id)
    got = oracle.apply_oracles({k: torch.from_numpy(v) for k, v in outs.items()},
                               {k: torch.from_numpy(v) for k, v in batch.items()}, which, symmetry_id)
    assert set(got) == set(ref) == set(outs)
    for k in outs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=1e-6, err_msg=k)
        assert (k in ("hm", "hm_hp", "hps", "hp_offset")) != np.array_equal(got[k].numpy(), outs[k]), k
    assert jax.numpy.abs(ref["hps"]).max() > 0
