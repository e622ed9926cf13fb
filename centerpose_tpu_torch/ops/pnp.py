"""Batched perspective-n-point on tensors, counterpart of `centerpose_tpu/ops/pnp.py`
— replaces per-object cv2.solvePnPGeneric loops.

Parity target: `CuboidPNPSolver.solve_pnp` (src/lib/utils/pnp/cuboid_pnp_solver.py:
91-239) as invoked by `pnp_shell` (cuboid_pnp_shell.py:11-93):
  * 2D points carry a "<-5000 == invalid" sentinel; each 2D point i corresponds
    to 3D cuboid corner i // (n_points / 8)  (rep_mode 1 passes 16 points:
    displacement and heatmap estimates interleaved per corner).
  * cv2.SOLVEPNP_ITERATIVE ≈ DLT initialization + Levenberg-Marquardt refinement
    of the reprojection error; here: weighted DLT via a 12x12
    eigendecomposition + branchless fixed-iteration LM.
  * below 6 valid points the reference switches to cv2.SOLVEPNP_EPNP; here a
    branchless EPnP initializer (4-eigenvector null space, β hypotheses
    N=1/2/3 with Gauss-Newton distance refinement) feeds the same LM.
  * z < 0 solutions are rejected (valid=False), matching
    cuboid_pnp_solver.py:207-220.
  * Returns both the OpenCV-frame pose and the OpenGL-converted pose (x↔y
    swap, z negated — cuboid_pnp_solver.py:179-196).

Every function carries the batch of M objects as the leading dimension (where
the JAX package maps a single-object function over the batch), is branchless
and stays in float32 on the device of its inputs: one detection count, one
program. Eigenvector signs and order differ between linear-algebra libraries,
so only the final pose, not an intermediate, is comparable across packages.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

_DLT_MIN_POINTS = 6  # below this the EPnP initializer takes over
_LM_ITERS = 20


class PnPResult(NamedTuple):
    valid: torch.Tensor           # [M] bool
    rotation: torch.Tensor        # [M, 3, 3] OpenCV-frame R
    translation: torch.Tensor     # [M, 3]    OpenCV-frame t
    quaternion: torch.Tensor      # [M, 4]    xyzw, OpenCV frame
    rotation_gl: torch.Tensor     # [M, 3, 3] OpenGL-converted
    translation_gl: torch.Tensor  # [M, 3]
    quaternion_gl: torch.Tensor   # [M, 4]    xyzw, OpenGL frame
    projected: torch.Tensor       # [M, 8, 2] reprojected cuboid corners (OpenCV projection)
    reproj_error: torch.Tensor    # [M]       mean reprojection error over valid points


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched linear solve that neither checks for singularity nor
    synchronises (a singular system gives inf/nan in its own row only)."""
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def _guard(m: torch.Tensor):
    """(matrices with every non-finite one replaced by the identity, [..., 1, 1]
    flag of the replaced ones). `torch.linalg.svd` / `eigh` raise on a
    non-finite input, which a branchless batch must survive: the row that a
    degenerate hypothesis poisoned gets NaN results (as it would from a
    library that does not check) and the other rows are untouched."""
    bad = ~torch.isfinite(m).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand_as(m)
    return torch.where(bad, eye, m), bad


def _svd(m: torch.Tensor):
    m, bad = _guard(m)
    u, s, vt = torch.linalg.svd(m)
    nan = torch.full_like(u, float("nan"))
    return torch.where(bad, nan, u), s, torch.where(bad, nan, vt)


def _eigh(m: torch.Tensor):
    m, bad = _guard(m)
    vals, vecs = torch.linalg.eigh(m)
    return (
        torch.where(bad[..., 0], torch.full_like(vals, float("nan")), vals),
        torch.where(bad, torch.full_like(vecs, float("nan")), vecs),
    )


def _diag11(d: torch.Tensor) -> torch.Tensor:
    """[...] → [..., 3, 3] diag(1, 1, d)."""
    ones = torch.ones_like(d)
    return torch.diag_embed(torch.stack([ones, ones, d], dim=-1))


def rotation_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] → quaternions [..., 4] (x, y, z, w),
    branchless Shepperd's method."""
    r00, r11, r22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    qw = torch.sqrt(torch.clamp_min(1.0 + r00 + r11 + r22, 1e-12)) / 2.0
    qx = torch.sqrt(torch.clamp_min(1.0 + r00 - r11 - r22, 1e-12)) / 2.0
    qy = torch.sqrt(torch.clamp_min(1.0 - r00 + r11 - r22, 1e-12)) / 2.0
    qz = torch.sqrt(torch.clamp_min(1.0 - r00 - r11 + r22, 1e-12)) / 2.0
    qx = torch.copysign(qx, r[..., 2, 1] - r[..., 1, 2])
    qy = torch.copysign(qy, r[..., 0, 2] - r[..., 2, 0])
    qz = torch.copysign(qz, r[..., 1, 0] - r[..., 0, 1])
    q = torch.stack([qx, qy, qz, qw], dim=-1)
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] → rotation matrices [..., 3, 3] (matrix exponential
    on so(3)), with the norm guarded at θ=0."""
    theta = torch.sqrt(torch.sum(rvec ** 2, dim=-1) + 1e-24)
    k = rvec / torch.clamp_min(theta, 1e-12)[..., None]
    zeros = torch.zeros_like(theta)
    kx = torch.stack(
        [
            torch.stack([zeros, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], zeros, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand_as(kx)
    r = (
        eye
        + torch.sin(theta)[..., None, None] * kx
        + (1.0 - torch.cos(theta))[..., None, None] * (kx @ kx)
    )
    return torch.where((theta < 1e-9)[..., None, None], eye, r)


def _project(points3d, r, t, camera):
    """[M, n, 3] points, [M, 3, 3] R, [M, 3] t, [M, 3, 3] K → [M, n, 2]."""
    pc = points3d @ r.transpose(-1, -2) + t[:, None, :]
    pz = pc[..., 2]
    z = torch.clamp_min(torch.abs(pz), 1e-9) * torch.sign(
        torch.where(pz == 0, torch.ones_like(pz), pz)
    )
    u = camera[:, 0, 0, None] * pc[..., 0] / z + camera[:, 0, 2, None]
    v = camera[:, 1, 1, None] * pc[..., 1] / z + camera[:, 1, 2, None]
    return torch.stack([u, v], dim=-1)


def _nearest_rotation(m: torch.Tensor) -> torch.Tensor:
    u, _, vt = _svd(m)
    d = torch.sign(torch.linalg.det(u @ vt))
    return u @ _diag11(d) @ vt


def _dlt_init(points3d, points2d_norm, weights):
    """Weighted DLT for [R|t] from normalized image points. Returns (R, t)."""
    x, y = points2d_norm[..., 0], points2d_norm[..., 1]
    ones = torch.ones_like(points3d[..., :1])
    xh = torch.cat([points3d, ones], dim=-1)               # [M, n, 4]
    zeros = torch.zeros_like(xh)
    row1 = torch.cat([xh, zeros, -x[..., None] * xh], dim=-1)  # [M, n, 12]
    row2 = torch.cat([zeros, xh, -y[..., None] * xh], dim=-1)
    a = torch.cat([row1, row2], dim=1)                     # [M, 2n, 12]
    a = a * torch.cat([weights, weights], dim=1)[..., None]

    ata = a.transpose(-1, -2) @ a
    _, vecs = _eigh(ata)
    p = vecs[:, :, 0].reshape(-1, 3, 4)                    # smallest eigenvector

    m = p[:, :, :3]
    # Scale so rows of R have unit norm on average; sign so points sit in front.
    scale = torch.clamp_min(torch.abs(torch.linalg.det(m)), 1e-12) ** (1.0 / 3.0)
    m = m / scale[:, None, None]
    t = p[:, :, 3] / scale[:, None]
    r = _nearest_rotation(m)
    # Choose the global sign so the (weighted) mean depth is positive.
    pc_z = (points3d @ r.transpose(-1, -2) + t[:, None, :])[..., 2]
    mean_z = torch.sum(pc_z * weights, dim=-1) / torch.clamp_min(
        torch.sum(weights, dim=-1), 1e-9
    )
    flip = torch.where(mean_z < 0, -torch.ones_like(mean_z), torch.ones_like(mean_z))
    # Flipping P's sign maps (R, t) -> (-R, -t): recompute from -m.
    r2 = _nearest_rotation(m * flip[:, None, None])
    return r2, t * flip[:, None]


def _procrustes_weighted(points_w, points_c, weights):
    """Weighted Kabsch: (R, t) with points_c ≈ R @ points_w + t."""
    wsum = torch.clamp_min(torch.sum(weights, dim=-1), 1e-9)[:, None]
    mu_w = torch.sum(points_w * weights[..., None], dim=1) / wsum
    mu_c = torch.sum(points_c * weights[..., None], dim=1) / wsum
    h = ((points_w - mu_w[:, None]) * weights[..., None]).transpose(-1, -2) @ (
        points_c - mu_c[:, None]
    )
    uu, _, vt = _svd(h)
    v = vt.transpose(-1, -2)
    ut = uu.transpose(-1, -2)
    dsign = torch.sign(torch.linalg.det(v @ ut))
    r = v @ _diag11(dsign) @ ut
    t = mu_c - (r @ mu_w[..., None])[..., 0]
    return r, t


_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


def _epnp_init(points3d, points2d_norm, weights):
    """EPnP initialization (Lepetit et al., OpenCV's hypothesis structure) for
    4/5-point solves.

    With n in {4, 5} the 12-dim control-point system MᵀM has a 2-4 dim null
    space, so the camera-frame control points are x = Σ βₖ vₖ over the 4
    smallest eigenvectors; the βs are pinned by the 6 inter-control-point
    distance equations: closed-form seeds for N = 1/2/3 active vectors, each
    Gauss-Newton-refined on the distance residuals, winner by weighted
    reprojection. Branchless and fixed-shape.
    """
    mb, n = points3d.shape[0], points3d.shape[1]
    dev, dt = points3d.device, points3d.dtype
    pair_i = torch.tensor(_PAIR_I, device=dev)
    pair_j = torch.tensor(_PAIR_J, device=dev)

    c0 = points3d.mean(dim=1)                              # [M, 3]
    d = points3d - c0[:, None]
    cov = d.transpose(-1, -2) @ d / n
    evals, evecs = _eigh(cov)
    axes = evecs * torch.sqrt(torch.clamp_min(evals, 1e-12))[:, None, :]  # columns = scaled axes
    ctrl_w = torch.cat([c0[:, None], c0[:, None] + axes.transpose(-1, -2)], dim=1)  # [M, 4, 3]

    beta_w = _solve(axes, d.transpose(-1, -2)).transpose(-1, -2)   # [M, n, 3]
    alpha = torch.cat(
        [1.0 - beta_w.sum(dim=-1, keepdim=True), beta_w], dim=-1
    )                                                      # [M, n, 4]

    u, v = points2d_norm[..., 0], points2d_norm[..., 1]
    zeros = torch.zeros_like(alpha)
    # Unknowns: camera-frame control points, ctrl-major (x, y, z) minor.
    mu = torch.stack([alpha, zeros, -alpha * u[..., None]], dim=-1).reshape(mb, n, 12)
    mv = torch.stack([zeros, alpha, -alpha * v[..., None]], dim=-1).reshape(mb, n, 12)
    m = torch.cat([mu, mv], dim=1) * torch.cat([weights, weights], dim=1)[..., None]
    _, vecs = _eigh(m.transpose(-1, -2) @ m)
    vnull = vecs[:, :, :4].transpose(-1, -2).reshape(mb, 4, 4, 3)  # [M, k, ctrl, xyz]

    # Pairwise control-point difference vectors per null vector: [M, k, 6, 3].
    dv = vnull[:, :, pair_i, :] - vnull[:, :, pair_j, :]
    dist2 = torch.sum((ctrl_w[:, pair_i] - ctrl_w[:, pair_j]) ** 2, dim=-1)  # [M, 6]

    def gram(a, b):  # Σ_xyz dv_a[p]·dv_b[p] per pair p -> [M, 6]
        return torch.sum(dv[:, a] * dv[:, b], dim=-1)

    def basis(i):
        e = torch.zeros(4, dtype=dt, device=dev)
        e[i] = 1.0
        return e

    # --- β seeds (OpenCV find_betas_approx_{1,2,3} analogue) ---
    g00 = gram(0, 0)
    b1_1 = torch.sqrt(
        torch.abs(torch.sum(dist2 * g00, dim=-1))
        / torch.clamp_min(torch.sum(g00 ** 2, dim=-1), 1e-12)
    )
    betas1 = basis(0) * b1_1[:, None]

    def _ls(lmat):
        ridge = 1e-9 * torch.eye(lmat.shape[-1], dtype=dt, device=dev)
        lt = lmat.transpose(-1, -2)
        return _solve(lt @ lmat + ridge, lt @ dist2[..., None])[..., 0]

    # N=2: unknowns [β11, β12, β22].
    y2 = _ls(torch.stack([g00, 2 * gram(0, 1), gram(1, 1)], dim=-1))
    b1 = torch.sqrt(torch.abs(y2[:, 0]))
    b2 = torch.sqrt(torch.abs(y2[:, 2])) * torch.sign(y2[:, 1]) * torch.sign(y2[:, 0] + 1e-30)
    betas2 = basis(0) * b1[:, None] + basis(1) * b2[:, None]

    # N=3: unknowns [β11, β12, β22, β13, β23, β33] (6 eqs, 6 unknowns).
    y3 = _ls(torch.stack(
        [g00, 2 * gram(0, 1), gram(1, 1), 2 * gram(0, 2), 2 * gram(1, 2), gram(2, 2)],
        dim=-1,
    ))
    b1 = torch.sqrt(torch.abs(y3[:, 0]))
    b2 = torch.sqrt(torch.abs(y3[:, 2])) * torch.sign(y3[:, 1]) * torch.sign(y3[:, 0] + 1e-30)
    b3 = y3[:, 3] / torch.where(torch.abs(b1) < 1e-12, torch.full_like(b1, 1e-12), b1)
    betas3 = basis(0) * b1[:, None] + basis(1) * b2[:, None] + basis(2) * b3[:, None]

    eye4 = 1e-6 * torch.eye(4, dtype=dt, device=dev)

    def gn_refine(betas):
        # Gauss-Newton on the 6 distance residuals over the full 4-vector β.
        for _ in range(6):
            diff = torch.einsum("mk,mkpx->mpx", betas, dv)          # [M, 6, 3]
            res = torch.sum(diff ** 2, dim=-1) - dist2              # [M, 6]
            jac = 2.0 * torch.einsum("mpx,mkpx->mpk", diff, dv)     # [M, 6, 4]
            jt = jac.transpose(-1, -2)
            betas = betas - _solve(jt @ jac + eye4, jt @ res[..., None])[..., 0]
        return betas

    def pose_from_betas(betas):
        ctrl_c = torch.einsum("mk,mkcx->mcx", betas, vnull)         # [M, 4, 3]
        pts_c = alpha @ ctrl_c
        wsum = torch.clamp_min(torch.sum(weights, dim=-1), 1e-9)
        mean_z = torch.sum(pts_c[..., 2] * weights, dim=-1) / wsum
        flip = torch.where(mean_z < 0, -torch.ones_like(mean_z), torch.ones_like(mean_z))
        pts_c = pts_c * flip[:, None, None]
        r, t = _procrustes_weighted(points3d, pts_c, weights)
        zc = torch.clamp_min(pts_c[..., 2], 1e-9)
        proj = torch.stack([pts_c[..., 0] / zc, pts_c[..., 1] / zc], dim=-1)
        err = torch.sum(torch.sum((proj - points2d_norm) ** 2, dim=-1) * weights, dim=-1)
        return r, t, err

    rs, ts, errs = zip(*[
        pose_from_betas(gn_refine(bt)) for bt in (betas1, betas2, betas3)
    ])
    rs, ts, errs = torch.stack(rs), torch.stack(ts), torch.stack(errs)   # [3, M, ...]
    best = torch.argmin(errs, dim=0)                                      # [M]
    r = torch.gather(rs, 0, best[None, :, None, None].expand(1, -1, 3, 3))[0]
    t = torch.gather(ts, 0, best[None, :, None].expand(1, -1, 3))[0]
    return r, t


def _lm_refine(points3d, points2d, weights, camera, r0, t0):
    """Fixed-iteration Levenberg-Marquardt on weighted reprojection error.

    State is (R, t) with LEFT multiplicative rotation updates R ← exp(δ)·R and
    a closed-form jacobian: with q = R·X, d(exp(δ)q + t)/dδ|₀ = −[q]× and
    ∂proj/∂pc the pinhole derivative. Exact linearization at the current
    estimate and no inverse-Rodrigues extraction (whose θ≈π branch is
    degenerate)."""
    mb = points3d.shape[0]
    dev, dt = points3d.device, points3d.dtype
    fx, fy = camera[:, 0, 0, None], camera[:, 1, 1, None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(r, t):
        proj = _project(points3d, r, t, camera)
        return ((proj - points2d) * weights[..., None]).reshape(mb, -1)

    def cost(r, t):
        return torch.sum(residuals(r, t) ** 2, dim=-1)

    def jacobian(r, t):
        q = points3d @ r.transpose(-1, -2)     # [M, n, 3] rotated points (pre-translation)
        pc = q + t[:, None, :]
        pz = pc[..., 2]
        tiny = torch.where(pz < 0, torch.full_like(pz, -1e-9), torch.full_like(pz, 1e-9))
        z = torch.where(torch.abs(pz) < 1e-9, tiny, pz)
        zi = 1.0 / z
        zeros = torch.zeros_like(zi)
        du = torch.stack([fx * zi, zeros, -fx * pc[..., 0] * zi * zi], dim=-1)
        dv = torch.stack([zeros, fy * zi, -fy * pc[..., 1] * zi * zi], dim=-1)
        # d pc/d[δ|t] = [−[q]× | I]  →  [M, n, 3, 6]
        q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
        mcross = torch.stack(
            [torch.stack([zeros, q3, -q2], dim=-1),
             torch.stack([-q3, zeros, q1], dim=-1),
             torch.stack([q2, -q1, zeros], dim=-1)], dim=-2
        )                                                    # [M, n, 3, 3]
        dpd = torch.cat([mcross, eye3.expand_as(mcross)], dim=-1)   # [M, n, 3, 6]
        ju = torch.einsum("mni,mnij->mnj", du, dpd)
        jv = torch.einsum("mni,mnij->mnj", dv, dpd)
        jac = torch.stack([ju, jv], dim=2) * weights[..., None, None]
        return jac.reshape(mb, -1, 6)                        # [M, 2n, 6]

    r, t = r0, t0
    lam = torch.full((mb,), 1e-3, dtype=dt, device=dev)
    best_cost = cost(r, t)
    for _ in range(_LM_ITERS):
        res = residuals(r, t)
        jac = jacobian(r, t)
        jt = jac.transpose(-1, -2)
        h = jt @ jac + lam[:, None, None] * eye6
        g = jt @ res[..., None]
        delta = _solve(h, g)[..., 0]
        r_cand = rodrigues(-delta[:, :3]) @ r
        t_cand = t - delta[:, 3:]
        cand_cost = cost(r_cand, t_cand)
        improved = cand_cost < best_cost
        r = torch.where(improved[:, None, None], r_cand, r)
        t = torch.where(improved[:, None], t_cand, t)
        lam = torch.where(improved, lam / 3.0, lam * 10.0).clamp(1e-10, 1e10)
        best_cost = torch.minimum(cand_cost, best_cost)
    return r, t, best_cost


# cuboid_pnp_solver.py:184-189
_GL_SWAP = ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, -1.0))


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def solve_pnp_batch(
    points2d,
    cuboid3d,
    camera,
    min_required_points: int = 4,
    device: Union[str, torch.device] = "cuda",
) -> PnPResult:
    """PnP over M objects at once: points2d [M, N, 2] (entries with any
    coordinate < -5000 are invalid, cuboid_pnp_solver.py:145), cuboid3d
    [M, 8, 3] corner coordinates (binary-counting order), camera [3, 3] shared
    or [M, 3, 3] per object. Arrays or tensors; the solve runs on `device`."""
    device = torch.device(device)
    points2d = _as_tensor(points2d, device)
    cuboid3d = _as_tensor(cuboid3d, device)
    camera = _as_tensor(camera, device)
    mb, n = points2d.shape[0], points2d.shape[1]
    if camera.dim() == 2:
        camera = camera[None].expand(mb, 3, 3)
    reps = n // 8  # each corner appears n/8 times (cuboid_pnp_solver.py:149)
    # rep_mode-1 layout interleaves per corner: [c0_disp, c0_heat, c1_disp, ...];
    # point i maps to corner i // reps.
    points3d = cuboid3d[:, torch.arange(n, device=device) // reps]

    weights = ((points2d[..., 0] > -5000) & (points2d[..., 1] > -5000)).to(torch.float32)
    n_valid = weights.sum(dim=-1)
    points2d_safe = torch.where(weights[..., None] > 0, points2d, torch.zeros_like(points2d))

    # Normalized coordinates for DLT.
    fx, fy = camera[:, 0, 0, None], camera[:, 1, 1, None]
    cx, cy = camera[:, 0, 2, None], camera[:, 1, 2, None]
    norm = torch.stack(
        [(points2d_safe[..., 0] - cx) / fx, (points2d_safe[..., 1] - cy) / fy], dim=-1
    )

    # DLT needs >= 6 correspondences; EPnP seeds 4/5-point solves. Both are
    # cheap at this size — compute both and select branchlessly.
    r_dlt, t_dlt = _dlt_init(points3d, norm, weights)
    r_ep, t_ep = _epnp_init(points3d, norm, weights)
    use_dlt = n_valid >= _DLT_MIN_POINTS
    r0 = torch.where(use_dlt[:, None, None], r_dlt, r_ep)
    t0 = torch.where(use_dlt[:, None], t_dlt, t_ep)
    r, t, _ = _lm_refine(points3d, points2d_safe, weights, camera, r0, t0)

    reproj = _project(cuboid3d, r, t, camera)
    per_pt = torch.linalg.norm(_project(points3d, r, t, camera) - points2d_safe, dim=-1)
    err = torch.sum(per_pt * weights, dim=-1) / torch.clamp_min(n_valid, 1.0)

    z_ok = t[:, 2] > 0  # cuboid_pnp_solver.py:207-220 z<0 => fail
    valid = (n_valid >= min_required_points) & z_ok

    swap = torch.tensor(_GL_SWAP, dtype=torch.float32, device=device)
    r_gl = swap @ r
    t_gl = t @ swap.T

    return PnPResult(
        valid=valid,
        rotation=r,
        translation=t,
        quaternion=rotation_to_quaternion(r),
        rotation_gl=r_gl,
        translation_gl=t_gl,
        quaternion_gl=rotation_to_quaternion(r_gl),
        projected=reproj,
        reproj_error=err,
    )


def solve_pnp_single(
    points2d,
    cuboid3d,
    camera,
    min_required_points: int = 4,
    device: Union[str, torch.device] = "cuda",
) -> PnPResult:
    """One object's pose from its (possibly invalid) 2D cuboid points:
    points2d [N, 2], cuboid3d [8, 3], camera [3, 3]."""
    device = torch.device(device)
    res = solve_pnp_batch(
        _as_tensor(points2d, device)[None], _as_tensor(cuboid3d, device)[None],
        _as_tensor(camera, device), min_required_points, device,
    )
    return PnPResult(*[v[0] for v in res])


def solve_pnp_batch_padded(
    points2d,
    cuboid3d,
    camera,
    min_required_points: int = 4,
    device: Union[str, torch.device] = "cuda",
) -> PnPResult:
    """solve_pnp_batch with the object count M padded to the next power of
    two, as the JAX package's function of this name does, so that serving
    runs a handful of batch shapes instead of one per detection count. Padded
    rows carry the -10000 invalid sentinel (n_valid=0 ⇒ valid=False) and a
    unit cuboid to keep the branchless solver well-posed; results are sliced
    back to M.

    `camera` may be [3, 3] (one intrinsic for all M) or [M, 3, 3] (per
    object — lets the serving path solve a whole multi-image batch in one
    call even when images carry different intrinsics). Padding happens in host
    numpy, then one transfer to `device`."""
    points2d = np.asarray(points2d)
    cuboid3d = np.asarray(cuboid3d)
    camera = np.asarray(camera)
    m = points2d.shape[0]
    mp = 1 << max(m - 1, 0).bit_length()
    if mp != m:
        pad = mp - m
        points2d = np.concatenate(
            [points2d,
             np.full((pad,) + points2d.shape[1:], -10000.0, points2d.dtype)],
            axis=0,
        )
        unit = np.array(
            [[(-0.5 if not (i & 4) else 0.5),
              (-0.5 if not (i & 2) else 0.5),
              (-0.5 if not (i & 1) else 0.5)] for i in range(8)],
            cuboid3d.dtype,
        )
        cuboid3d = np.concatenate(
            [cuboid3d, np.broadcast_to(unit, (pad, 8, 3))], axis=0
        )
        if camera.ndim == 3:
            # Benign intrinsic for the dead rows (weights are all zero there,
            # but the branchless DLT/EPnP still divides by fx/fy).
            safe = np.array(
                [[500.0, 0.0, 0.0], [0.0, 500.0, 0.0], [0.0, 0.0, 1.0]],
                camera.dtype,
            )
            camera = np.concatenate(
                [camera, np.broadcast_to(safe, (pad, 3, 3))], axis=0
            )
    res = solve_pnp_batch(points2d, cuboid3d, camera, min_required_points, device)
    if mp != m:
        res = PnPResult(*[v[:m] for v in res])
    return res
