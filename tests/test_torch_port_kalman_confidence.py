"""`KeypointKalman.confidence` without overflow: a track whose covariance
has grown reads confidence 0 with no floating-point warning, and every value
the published formula computes finitely comes out the same, bit for bit."""

import numpy as np
import pytest

from centerpose_tpu_torch.tracking.kalman import KeypointKalman

BORDERS = [(3.0, 9.0), (2.0, 5.0), (9.0, 3.0)]


def _filter(var_x, var_y):
    j = len(var_x)
    p = np.zeros((j, 4, 4))
    p[:, 0, 0], p[:, 1, 1] = var_x, var_y
    p[:, 2, 2] = p[:, 3, 3] = 20.0
    return KeypointKalman(x=np.zeros((j, 4)), p=p)


def _published(kf, conf_border):
    """The formula as the tracker publishes it (tracker.py:258-262)."""
    b0, b1 = conf_border
    std_combined = np.sqrt(kf.p[:, 0, 0] + kf.p[:, 1, 1])
    base = np.exp(np.log(0.15) / (b0 - b1))
    with np.errstate(over="ignore"):
        return np.maximum(1.0 - base ** (std_combined - b1), 0.0)


def test_large_covariance_reads_zero_without_warning():
    kf = _filter(np.array([1e7, 4e6, 1e300, 2.5e5]), np.array([1e7, 1.0, 1e300, 2.5e5]))
    with np.errstate(all="raise"):
        conf = kf.confidence((3.0, 9.0))
    np.testing.assert_array_equal(conf, np.zeros(4))


@pytest.mark.parametrize("conf_border", BORDERS)
def test_ordinary_values_equal_the_published_formula(conf_border):
    var = np.linspace(0.0, 400.0, 4001)
    kf = _filter(var, var * 0.5)
    with np.errstate(all="raise"):
        conf = kf.confidence(conf_border)
    np.testing.assert_array_equal(conf, _published(kf, conf_border))
    assert 0.0 < conf.max() < 1.0 and conf.min() == 0.0
