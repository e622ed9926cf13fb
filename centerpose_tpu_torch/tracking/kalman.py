"""Keypoint Kalman filter as vectorized 4-state blocks.

The package's own copy of `centerpose_tpu/tracking/kalman.py` (numpy only;
the tracker's filter runs on the host in both packages).

Parity target: the reference's 32-state filterpy KalmanFilter (src/lib/utils/
tracker.py:55-96). That filter is exactly block-diagonal — 8 independent
(x, y, vx, vy) filters per object — so it is implemented here as [8, 4] state /
[8, 4, 4] covariance arrays with identical math (F with unit velocity coupling,
H = I, Q = I as filterpy's default, P0 = R0, Joseph-form update), vectorized over
keypoints and over tracks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_F = np.array(
    [
        [1.0, 0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0, 1.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
_I4 = np.eye(4)


def _measurement_r(kps_std: np.ndarray, r_velocity: float) -> np.ndarray:
    """[J, 4, 4] diag(std_x^2, std_y^2, R, R) per keypoint (tracker.py:63-67)."""
    j = kps_std.shape[0] // 2
    r = np.zeros((j, 4, 4))
    r[:, 0, 0] = kps_std[0::2] ** 2
    r[:, 1, 1] = kps_std[1::2] ** 2
    r[:, 2, 2] = r_velocity
    r[:, 3, 3] = r_velocity
    return r


def _measurement_z(kps_mean: np.ndarray, tracking_hp: np.ndarray) -> np.ndarray:
    """[J, 4] observation (x, y, -thp_x, -thp_y): velocity is measured as minus the
    tracking_hp offset (current - previous) — tracker.py:72-77."""
    j = kps_mean.shape[0] // 2
    z = np.zeros((j, 4))
    z[:, 0] = kps_mean[0::2]
    z[:, 1] = kps_mean[1::2]
    z[:, 2] = -tracking_hp[0::2]
    z[:, 3] = -tracking_hp[1::2]
    return z


@dataclasses.dataclass
class KeypointKalman:
    """Per-object filter over J keypoints. x: [J, 4], p: [J, 4, 4]."""

    x: np.ndarray
    p: np.ndarray
    r_velocity: float = 20.0

    @classmethod
    def init(
        cls, kps_mean: np.ndarray, kps_std: np.ndarray, tracking_hp: np.ndarray,
        r_velocity: float = 20.0,
    ) -> "KeypointKalman":
        r0 = _measurement_r(kps_std, r_velocity)
        return cls(x=_measurement_z(kps_mean, tracking_hp), p=r0.copy(),
                   r_velocity=r_velocity)

    def predict(self) -> None:
        """x <- Fx, P <- FPF' + Q (Q = I, filterpy default)."""
        self.x = self.x @ _F.T
        self.p = _F @ self.p @ _F.T + _I4

    def update(
        self, kps_mean: np.ndarray, kps_std: np.ndarray, tracking_hp: np.ndarray
    ) -> None:
        z = _measurement_z(kps_mean, tracking_hp)
        r = _measurement_r(kps_std, self.r_velocity)
        s = self.p + r  # H = I
        k = self.p @ np.linalg.inv(s)
        self.x = self.x + (k @ (z - self.x)[..., None])[..., 0]
        i_kh = _I4 - k
        # Joseph form, as filterpy does.
        self.p = i_kh @ self.p @ i_kh.transpose(0, 2, 1) + k @ r @ k.transpose(0, 2, 1)

    def update_positions(self, kps_mean: np.ndarray, kps_std: np.ndarray) -> None:
        """Position-only update (H observes x, y) — the CenterPose+KF baseline
        tracker's dim_z=16 filter (tracker_baseline.py:55-77)."""
        j = self.x.shape[0]
        z = np.zeros((j, 2))
        z[:, 0] = kps_mean[0::2]
        z[:, 1] = kps_mean[1::2]
        r = np.zeros((j, 2, 2))
        r[:, 0, 0] = kps_std[0::2] ** 2
        r[:, 1, 1] = kps_std[1::2] ** 2

        hmat = np.zeros((2, 4))
        hmat[0, 0] = hmat[1, 1] = 1.0
        s = hmat @ self.p @ hmat.T + r  # [J, 2, 2]
        k = self.p @ hmat.T @ np.linalg.inv(s)  # [J, 4, 2]
        innov = z - self.x[:, :2]
        self.x = self.x + (k @ innov[..., None])[..., 0]
        i_kh = _I4 - k @ hmat
        self.p = i_kh @ self.p @ i_kh.transpose(0, 2, 1) + k @ r @ k.transpose(0, 2, 1)

    @property
    def mean_velocity(self) -> np.ndarray:
        """[2] mean (vx, vy) across keypoints — used by the baseline tracker to
        predict the association center (tracker_baseline.py:134-140)."""
        return self.x[:, 2:].mean(axis=0)

    # -------------------------------------------------------------- accessors
    @property
    def positions(self) -> np.ndarray:
        """[J, 2] filtered keypoint positions."""
        return self.x[:, :2].copy()

    @property
    def position_std(self) -> np.ndarray:
        """[2J] interleaved per-coordinate std from P diagonal."""
        j = self.x.shape[0]
        out = np.zeros(2 * j)
        out[0::2] = np.sqrt(self.p[:, 0, 0])
        out[1::2] = np.sqrt(self.p[:, 1, 1])
        return out

    def confidence(self, conf_border) -> np.ndarray:
        """Per-keypoint confidence from covariance (tracker.py:258-262):
        conf = max(1 - exp(ln(0.15)/(b0-b1))^(std_combined - b1), 0)."""
        b0, b1 = conf_border
        std_combined = np.sqrt(self.p[:, 0, 0] + self.p[:, 1, 1])
        base = np.exp(np.log(0.15) / (b0 - b1))
        return np.maximum(1.0 - base ** (std_combined - b1), 0.0)
