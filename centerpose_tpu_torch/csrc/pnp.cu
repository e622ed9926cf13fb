// Batched perspective-n-point: the pose of each of M objects from its n
// 2D-3D correspondences, one warp an object, in one launch. It computes what
// `centerpose_tpu_torch/ops/pnp.py::_solve_on_device` (the plain version)
// computes, in float32 throughout:
//
//   weights w_i = 1 where both coordinates of point i are > -5000, else 0 (the
//   point is then read as (0, 0)); point i corresponds to cuboid corner
//   i / (n / 8);
//   initial pose: the weighted DLT (smallest eigenvector of A^T A, 12x12,
//   scaled to |det| = 1, nearest rotation, the sign that puts the weighted
//   mean depth in front) where the row has >= 6 valid points, else the EPnP
//   initializer (4 smallest eigenvectors of M^T M, beta seeds N = 1/2/3 each
//   refined by 6 Gauss-Newton steps on the control-point distances, weighted
//   Procrustes, the seed with the least reprojection error in normalized
//   coordinates);
//   20 Levenberg-Marquardt iterations on the weighted pixel reprojection
//   error, left-multiplicative Rodrigues updates, lambda from 1e-3, /3 on an
//   improvement and x10 otherwise, clamped to [1e-10, 1e10];
//   outputs: the OpenCV pose, the OpenGL pose (x <-> y swapped, z negated),
//   both quaternions (xyzw, Shepperd), the projected cuboid, the mean
//   reprojection error over valid points, valid = n_valid >= min_required and
//   t_z > 0 (NaN gives invalid).
//
// Replaces no TPU kernel: the JAX package's PnP is one jitted XLA program.
// It exists because on the H100 the eager version is bound by its launches
// and the host, not by arithmetic: a serving chunk's 128 objects of 16 points
// need ~11 MFLOP (0.16 us at the 67 TFLOP/s of the FMA units) and ~56 KB in
// and out, while the eager chain launches thousands of tiny kernels with
// host waits between its linear-algebra calls. Here one launch does the
// whole solve, and nothing reaches device memory but one packed input row and
// one packed output row per object.
//
// Design. A block is one warp and owns one object, so the kernel takes any M
// and each row chooses its own initializer (a warp computes only the one its
// row takes). Lanes loop over the object's points for every sum over points
// (the 12x12 Gram matrices one entry a lane, the means, cross-covariance and
// the Levenberg-Marquardt normal equations as per-lane partials reduced by an
// xor butterfly, which leaves every lane with the same bits, so all lanes take
// the same branches). The 12x12 symmetric eigenproblems are cyclic Jacobi in
// shared memory, one lane a row for each rotation; the 3x3 and 4x4 ones, the
// 6x6 / 4x4 / 3x3 solves (Gaussian elimination with partial pivoting, as the
// plain version's LU) and the rest run on every lane alike in registers. The
// nearest rotation to a 3x3 matrix (the polar factor with det +1 that the
// plain version takes from an SVD, argmax over rotations R of tr(R^T M)) is
// the eigenvector of the largest eigenvalue of Horn's 4x4 symmetric matrix,
// read as a quaternion. A non-finite matrix gives NaN eigenvectors, so a
// degenerate row ends NaN or invalid, never a fault. Each row is bounded by
// its dependent chain of small steps (one warp, one SM), not by the card's
// throughput: rows run side by side on the 132 SMs.
//
// Layouts (float32, row-major, contiguous):
//   inputs  [M, 2n + 28]: the n points (x, y), the cuboid's 8 corners (x, y,
//           z), then fx, fy, cx, cy;
//   outputs [M, 50]: valid (1 or 0), R [3x3], t [3], q [4], R_gl [3x3],
//           t_gl [3], q_gl [4], projected corners [8x2], mean error.
// n is a multiple of 8, 8 <= n <= 1024.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr int TAIL = 28;            // after a row's 2n coordinates: cuboid (24), fx, fy, cx, cy
constexpr int RESULT_WIDTH = 50;
constexpr int MAX_POINTS = 1024;
constexpr int DLT_MIN_POINTS = 6;   // below this the EPnP initializer takes over
constexpr int LM_ITERS = 20;
constexpr int GN_ITERS = 6;
constexpr int MAX_SWEEPS = 30;      // Jacobi sweeps; a 12x12 converges in well under 10
constexpr float INVALID = -5000.f;  // a coordinate at or below it marks the point invalid

// (i, j) control-point pairs of EPnP's six distance equations.
__constant__ int PAIR_I[6] = {0, 0, 0, 1, 1, 2};
__constant__ int PAIR_J[6] = {1, 2, 3, 2, 3, 3};

// Shared memory of one block, in floats.
__host__ __device__ inline int smem_floats(int n) {
  return 2 * n      // points (0 where invalid)
         + n        // weights
         + 24       // cuboid corners
         + 4 * n    // EPnP barycentric coordinates
         + 144      // 12x12 matrix
         + 144      // its eigenvectors
         + 72       // EPnP control-point differences [4 vectors][6 pairs][xyz]
         + 48       // EPnP null-space vectors [4][4 controls][xyz]
         + 12;      // eigenvalue order (int)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int K>
__device__ __forceinline__ void warp_sum(float (&v)[K]) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

__device__ __forceinline__ float sign_of(float x) {  // torch.sign: 0 at 0
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// A depth kept off 0 by 1e-9 with its sign (+ at 0), as the plain version's
// projection and Jacobian take it.
__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-9f ? (z < 0.f ? -1e-9f : 1e-9f) : z;
}

struct Pose {
  float r[9];
  float t[3];
};

// One object's point data in shared memory, and its camera.
struct Obj {
  const float* pt;   // [n][2]
  const float* w;    // [n]
  const float* cub;  // [8][3]
  float fx, fy, cx, cy;
  int n, reps, lane;

  __device__ __forceinline__ void corner(int i, float (&x)[3]) const {
    const float* c = cub + 3 * (i / reps);
    x[0] = c[0];
    x[1] = c[1];
    x[2] = c[2];
  }
};

// ------------------------------------------------------- small dense algebra
// Solves a x = b in place (b becomes x) by Gaussian elimination with partial
// pivoting; a singular system gives inf/NaN, as an unchecked LU does.
template <int N>
__device__ __forceinline__ void solve_gauss(float (&a)[N][N], float (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int piv = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      if (fabsf(a[r][k]) > best) {
        best = fabsf(a[r][k]);
        piv = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      if (r == piv) {
#pragma unroll
        for (int c = k; c < N; ++c) {
          const float tmp = a[k][c];
          a[k][c] = a[r][c];
          a[r][c] = tmp;
        }
        const float tmp = b[k];
        b[k] = b[r];
        b[r] = tmp;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float f = a[r][k] / a[k][k];
#pragma unroll
      for (int c = k + 1; c < N; ++c) a[r][c] -= f * a[k][c];
      b[r] -= f * b[k];
    }
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    float s = b[k];
#pragma unroll
    for (int c = k + 1; c < N; ++c) s -= a[k][c] * b[c];
    b[k] = s / a[k][k];
  }
}

// One Jacobi rotation's (t, c, s) that zeroes a_pq, or false where a_pq is
// negligible beside both diagonal entries after the first sweeps (Numerical
// Recipes' rule; a_pq is then set to 0).
__device__ __forceinline__ bool jacobi_angle(float app, float aqq, float apq, int sweep, float* t,
                                             float* c, float* s) {
  const float g = 100.f * fabsf(apq);
  if (sweep > 3 && fabsf(app) + g == fabsf(app) && fabsf(aqq) + g == fabsf(aqq)) return false;
  const float h = aqq - app;
  float tt;
  if (fabsf(h) + g == fabsf(h)) {
    tt = apq / h;
  } else {
    const float theta = 0.5f * h / apq;
    tt = 1.f / (fabsf(theta) + sqrtf(1.f + theta * theta));
    if (theta < 0.f) tt = -tt;
  }
  *t = tt;
  *c = 1.f / sqrtf(1.f + tt * tt);
  *s = tt * *c;
  return true;
}

// Eigen-decomposition of a symmetric N x N matrix in registers (every lane
// alike): a ends diagonal, v's columns are the eigenvectors (unsorted). A
// non-finite input gives NaN eigenvalues and eigenvectors.
template <int N>
__device__ __forceinline__ void jacobi_small(float (&a)[N][N], float (&v)[N][N]) {
  bool finite = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      finite = finite && isfinite(a[i][j]);
      v[i][j] = i == j ? 1.f : 0.f;
    }
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] = v[i][j] = NAN;
    }
    return;
  }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float apq = a[p][q];
        if (apq == 0.f) continue;
        float t, c, s;
        if (!jacobi_angle(a[p][p], a[q][q], apq, sweep, &t, &c, &s)) {
          a[p][q] = a[q][p] = 0.f;
          continue;
        }
        rotated = true;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (k == p || k == q) continue;
          const float akp = a[k][p], akq = a[k][q];
          a[k][p] = a[p][k] = c * akp - s * akq;
          a[k][q] = a[q][k] = s * akp + c * akq;
        }
        a[p][p] -= t * apq;
        a[q][q] += t * apq;
        a[p][q] = a[q][p] = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
    if (!rotated) break;
  }
}

// The same for the 12x12 matrix a in shared memory, one lane a row of each
// rotation; v gets the eigenvectors as columns and order[k] the column of the
// k-th smallest eigenvalue. Called by the whole warp.
__device__ void jacobi12(float* a, float* v, int* order, int lane) {
  float all = 0.f;
  for (int i = lane; i < 144; i += WARP) {
    v[i] = i % 13 == 0 ? 1.f : 0.f;
    all += a[i] * a[i];
  }
  all = warp_sum(all);
  __syncwarp();
  if (!isfinite(all)) {                       // a non-finite input: NaN out
    for (int i = lane; i < 144; i += WARP) a[i] = v[i] = NAN;
    if (lane < 12) order[lane] = lane;
    __syncwarp();
    return;
  }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < 11; ++p) {
      for (int q = p + 1; q < 12; ++q) {
        const float apq = a[p * 12 + q];
        if (apq == 0.f) continue;
        const float app = a[p * 13], aqq = a[q * 13];
        float t, c, s;
        const bool rotate = jacobi_angle(app, aqq, apq, sweep, &t, &c, &s);
        __syncwarp();                         // every lane has read a_pp, a_qq, a_pq
        if (!rotate) {
          if (lane == 0) a[p * 12 + q] = a[q * 12 + p] = 0.f;
          __syncwarp();
          continue;
        }
        rotated = true;
        if (lane < 12) {
          const int k = lane;
          if (k != p && k != q) {             // rows k read and write only their own entries
            const float akp = a[k * 12 + p], akq = a[k * 12 + q];
            const float nkp = c * akp - s * akq, nkq = s * akp + c * akq;
            a[k * 12 + p] = nkp;
            a[p * 12 + k] = nkp;
            a[k * 12 + q] = nkq;
            a[q * 12 + k] = nkq;
          }
          const float vkp = v[k * 12 + p], vkq = v[k * 12 + q];
          v[k * 12 + p] = c * vkp - s * vkq;
          v[k * 12 + q] = s * vkp + c * vkq;
        } else if (lane == 12) {
          a[p * 13] = app - t * apq;
          a[q * 13] = aqq + t * apq;
          a[p * 12 + q] = a[q * 12 + p] = 0.f;
        }
        __syncwarp();
      }
    }
    if (!rotated) break;
  }
  if (lane < 12) {                            // ascending, ties by index
    const float d = a[lane * 13];
    int rank = 0;
    for (int j = 0; j < 12; ++j) {
      const float dj = a[j * 13];
      rank += (dj < d || (dj == d && j < lane)) ? 1 : 0;
    }
    order[rank] = lane;
  }
  __syncwarp();
}

// Rotation matrix of the quaternion (w, x, y, z), normalised here.
__device__ __forceinline__ void quat_to_rot(float w, float x, float y, float z, float (&r)[9]) {
  const float inv = 1.f / sqrtf(w * w + x * x + y * y + z * z);
  w *= inv;
  x *= inv;
  y *= inv;
  z *= inv;
  r[0] = w * w + x * x - y * y - z * z;
  r[1] = 2.f * (x * y - w * z);
  r[2] = 2.f * (x * z + w * y);
  r[3] = 2.f * (x * y + w * z);
  r[4] = w * w - x * x + y * y - z * z;
  r[5] = 2.f * (y * z - w * x);
  r[6] = 2.f * (x * z - w * y);
  r[7] = 2.f * (y * z + w * x);
  r[8] = w * w - x * x - y * y + z * z;
}

// The rotation R that maximises tr(R^T m) (row-major m): the plain version's
// U diag(1, 1, sign det(U V^T)) V^T of m = U S V^T, here the quaternion of
// the largest eigenvalue of Horn's matrix K(m), for which tr(R(q)^T m) = q^T K q.
__device__ __forceinline__ void nearest_rotation(const float (&m)[9], float (&r)[9]) {
  float k[4][4], v[4][4];
  k[0][0] = m[0] + m[4] + m[8];
  k[1][1] = m[0] - m[4] - m[8];
  k[2][2] = -m[0] + m[4] - m[8];
  k[3][3] = -m[0] - m[4] + m[8];
  k[0][1] = k[1][0] = m[7] - m[5];
  k[0][2] = k[2][0] = m[2] - m[6];
  k[0][3] = k[3][0] = m[3] - m[1];
  k[1][2] = k[2][1] = m[1] + m[3];
  k[1][3] = k[3][1] = m[2] + m[6];
  k[2][3] = k[3][2] = m[5] + m[7];
  jacobi_small<4>(k, v);
  int best = 0;
  float top = k[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (k[i][i] > top) {
      top = k[i][i];
      best = i;
    }
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = v[i][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (best == j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = v[i][j];
    }
  }
  quat_to_rot(q[0], q[1], q[2], q[3], r);
}

__device__ __forceinline__ float det3(const float (&m)[9]) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

// q = (x, y, z, w) of a rotation matrix: Shepperd's method without branches,
// as `rotation_to_quaternion`.
__device__ __forceinline__ void rot_to_quat(const float (&r)[9], float* out) {
  float qw = sqrtf(fmaxf(1.f + r[0] + r[4] + r[8], 1e-12f)) / 2.f;
  float qx = sqrtf(fmaxf(1.f + r[0] - r[4] - r[8], 1e-12f)) / 2.f;
  float qy = sqrtf(fmaxf(1.f - r[0] + r[4] - r[8], 1e-12f)) / 2.f;
  float qz = sqrtf(fmaxf(1.f - r[0] - r[4] + r[8], 1e-12f)) / 2.f;
  qx = copysignf(qx, r[7] - r[5]);
  qy = copysignf(qy, r[2] - r[6]);
  qz = copysignf(qz, r[3] - r[1]);
  const float norm = fmaxf(sqrtf(qx * qx + qy * qy + qz * qz + qw * qw), 1e-12f);
  out[0] = qx / norm;
  out[1] = qy / norm;
  out[2] = qz / norm;
  out[3] = qw / norm;
}

// Axis-angle -> rotation (`rodrigues`), the identity below 1e-9 rad.
__device__ __forceinline__ void rodrigues(float rx, float ry, float rz, float (&r)[9]) {
  const float theta = sqrtf(rx * rx + ry * ry + rz * rz + 1e-24f);
  const float inv = 1.f / fmaxf(theta, 1e-12f);
  const float kx = rx * inv, ky = ry * inv, kz = rz * inv;
  const float k[9] = {0.f, -kz, ky, kz, 0.f, -kx, -ky, kx, 0.f};
  const float sn = sinf(theta), cs = 1.f - cosf(theta);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float kk = 0.f;
#pragma unroll
      for (int l = 0; l < 3; ++l) kk += k[3 * i + l] * k[3 * l + j];
      r[3 * i + j] = (i == j ? 1.f : 0.f) + sn * k[3 * i + j] + cs * kk;
    }
  }
  if (theta < 1e-9f) {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = (i % 4 == 0) ? 1.f : 0.f;
  }
}

__device__ __forceinline__ void rotate(const float (&r)[9], const float (&x)[3], float (&y)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = r[3 * i] * x[0] + r[3 * i + 1] * x[1] + r[3 * i + 2] * x[2];
}

// ------------------------------------------------------------------- DLT
__device__ Pose dlt_init(const Obj& o, float* sa, float* sv, int* order, float wsum) {
  // A^T A over the weighted rows [X, 1, 0, -x X, -x] and [0, X, 1, -y X, -y]
  // of each point in normalized coordinates, one entry a lane.
  for (int e = o.lane; e < 144; e += WARP) {
    const int a = e / 12, b = e % 12;
    float acc = 0.f;
    for (int i = 0; i < o.n; ++i) {
      const float w = o.w[i];
      float x3[3];
      o.corner(i, x3);
      const float xh[4] = {x3[0], x3[1], x3[2], 1.f};
      const float u = (o.pt[2 * i] - o.cx) / o.fx, v = (o.pt[2 * i + 1] - o.cy) / o.fy;
      const float r1a = a < 4 ? xh[a] : (a < 8 ? 0.f : -u * xh[a - 8]);
      const float r1b = b < 4 ? xh[b] : (b < 8 ? 0.f : -u * xh[b - 8]);
      const float r2a = a < 4 ? 0.f : (a < 8 ? xh[a - 4] : -v * xh[a - 8]);
      const float r2b = b < 4 ? 0.f : (b < 8 ? xh[b - 4] : -v * xh[b - 8]);
      acc += (w * r1a) * (w * r1b) + (w * r2a) * (w * r2b);
    }
    sa[e] = acc;
  }
  __syncwarp();
  jacobi12(sa, sv, order, o.lane);
  const int c0 = order[0];
  float p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = sv[k * 12 + c0];
  __syncwarp();                                // sa / sv are free again

  float m[9] = {p[0], p[1], p[2], p[4], p[5], p[6], p[8], p[9], p[10]};
  // Rows of R of unit norm on average, then the sign that puts the points in front.
  const float scale = cbrtf(fmaxf(fabsf(det3(m)), 1e-12f));
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] /= scale;
  float t[3] = {p[3] / scale, p[7] / scale, p[11] / scale};
  float r[9];
  nearest_rotation(m, r);
  float zsum = 0.f;
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3];
    o.corner(i, x3);
    zsum += (r[6] * x3[0] + r[7] * x3[1] + r[8] * x3[2] + t[2]) * o.w[i];
  }
  zsum = warp_sum(zsum);
  const float flip = zsum / fmaxf(wsum, 1e-9f) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] *= flip;
  Pose out;
  nearest_rotation(m, out.r);
#pragma unroll
  for (int k = 0; k < 3; ++k) out.t[k] = t[k] * flip;
  return out;
}

// ------------------------------------------------------------------ EPnP
// The weighted camera-frame control points of one beta hypothesis: the sums
// its pose and score need, over the points.
struct Hypothesis {
  float err;       // weighted squared reprojection error, normalized coordinates
  float mu_c[3];   // weighted mean camera-frame point (after the depth flip)
  float h[9];      // sum w (X - mu_w)(p_c - mu_c)^T
};

__device__ void gauss_newton(const float* dv, const float (&dist2)[6], float (&beta)[4]) {
  for (int it = 0; it < GN_ITERS; ++it) {
    float jtj[4][4], jtr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      jtr[a] = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) jtj[a][b] = a == b ? 1e-6f : 0.f;
    }
    float jac[6][4], res[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      float diff[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) s += beta[k] * dv[(k * 6 + p) * 3 + x];
        diff[x] = s;
      }
      res[p] = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2] - dist2[p];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* d = dv + (k * 6 + p) * 3;
        jac[p][k] = 2.f * (diff[0] * d[0] + diff[1] * d[1] + diff[2] * d[2]);
      }
    }
    float sys[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < 6; ++p) s += jac[p][a] * jac[p][b];
        sys[a][b] = s + jtj[a][b];
      }
      float g = 0.f;
#pragma unroll
      for (int p = 0; p < 6; ++p) g += jac[p][a] * res[p];
      jtr[a] = g;
    }
    solve_gauss<4>(sys, jtr);
#pragma unroll
    for (int k = 0; k < 4; ++k) beta[k] -= jtr[k];
  }
}

// Least squares L y = dist2 through the ridge-regularised normal equations.
template <int N>
__device__ __forceinline__ void betas_ls(const float (&l)[6][N], const float (&dist2)[6],
                                         float (&y)[N]) {
  float a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < 6; ++p) s += l[p][i] * l[p][j];
      a[i][j] = s + (i == j ? 1e-9f : 0.f);
    }
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < 6; ++p) s += l[p][i] * dist2[p];
    y[i] = s;
  }
  solve_gauss<N>(a, y);
}

__device__ Hypothesis score_betas(const Obj& o, const float* alpha, const float* vnull,
                                  const float (&beta)[4], const float (&mu_w)[3], float wsum) {
  float ctrl[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += beta[k] * vnull[k * 12 + e];
    ctrl[e] = s;
  }
  // Pass 1: the weighted mean camera-frame point; its depth chooses the sign.
  float sums[3] = {0.f, 0.f, 0.f};
  for (int i = o.lane; i < o.n; i += WARP) {
    const float* al = alpha + 4 * i;
    const float w = o.w[i];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float pc = al[0] * ctrl[x] + al[1] * ctrl[3 + x] + al[2] * ctrl[6 + x] + al[3] * ctrl[9 + x];
      sums[x] += pc * w;
    }
  }
  warp_sum(sums);
  const float ws = fmaxf(wsum, 1e-9f);
  const float flip = sums[2] / ws < 0.f ? -1.f : 1.f;
  Hypothesis hy;
#pragma unroll
  for (int x = 0; x < 3; ++x) hy.mu_c[x] = flip * sums[x] / ws;
  // Pass 2: the cross-covariance and the reprojection error.
  float acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.f;
  for (int i = o.lane; i < o.n; i += WARP) {
    const float* al = alpha + 4 * i;
    const float w = o.w[i];
    float pc[3], x3[3];
#pragma unroll
    for (int x = 0; x < 3; ++x)
      pc[x] = flip * (al[0] * ctrl[x] + al[1] * ctrl[3 + x] + al[2] * ctrl[6 + x] + al[3] * ctrl[9 + x]);
    o.corner(i, x3);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[3 * a + b] += (x3[a] - mu_w[a]) * w * (pc[b] - hy.mu_c[b]);
    }
    const float zc = fmaxf(pc[2], 1e-9f);
    const float du = pc[0] / zc - (o.pt[2 * i] - o.cx) / o.fx;
    const float dvv = pc[1] / zc - (o.pt[2 * i + 1] - o.cy) / o.fy;
    acc[9] += (du * du + dvv * dvv) * w;
  }
  warp_sum(acc);
#pragma unroll
  for (int k = 0; k < 9; ++k) hy.h[k] = acc[k];
  hy.err = acc[9];
  return hy;
}

__device__ Pose epnp_init(const Obj& o, float* alpha, float* sa, float* sv, float* dv,
                          float* vnull, int* order, float wsum) {
  // Control points: the centroid and the principal axes of the n points
  // (unweighted), scaled by their standard deviations.
  float s3[3] = {0.f, 0.f, 0.f};
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3];
    o.corner(i, x3);
#pragma unroll
    for (int x = 0; x < 3; ++x) s3[x] += x3[x];
  }
  warp_sum(s3);
  float c0[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) c0[x] = s3[x] / o.n;
  float cv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // xx xy xz yy yz zz
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3];
    o.corner(i, x3);
    const float d0 = x3[0] - c0[0], d1 = x3[1] - c0[1], d2 = x3[2] - c0[2];
    cv[0] += d0 * d0;
    cv[1] += d0 * d1;
    cv[2] += d0 * d2;
    cv[3] += d1 * d1;
    cv[4] += d1 * d2;
    cv[5] += d2 * d2;
  }
  warp_sum(cv);
  float cov[3][3] = {{cv[0], cv[1], cv[2]}, {cv[1], cv[3], cv[4]}, {cv[2], cv[4], cv[5]}};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) cov[a][b] /= o.n;
  }
  float ev[3][3];
  jacobi_small<3>(cov, ev);
  float lam[3] = {cov[0][0], cov[1][1], cov[2][2]};
  // Ascending eigenvalues, their eigenvectors with them.
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int i = pass == 1 ? 1 : 0;
    if (lam[i + 1] < lam[i]) {
      const float tl = lam[i];
      lam[i] = lam[i + 1];
      lam[i + 1] = tl;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float tv = ev[r][i];
        ev[r][i] = ev[r][i + 1];
        ev[r][i + 1] = tv;
      }
    }
  }
  float sigma[3], ctrl_w[4][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sigma[k] = sqrtf(fmaxf(lam[k], 1e-12f));
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    ctrl_w[0][x] = c0[x];
#pragma unroll
    for (int k = 0; k < 3; ++k) ctrl_w[k + 1][x] = c0[x] + ev[x][k] * sigma[k];
  }
  // Barycentric coordinates: X - c0 = axes beta (axes = E diag(sigma)).
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3];
    o.corner(i, x3);
    const float d[3] = {x3[0] - c0[0], x3[1] - c0[1], x3[2] - c0[2]};
    float bsum = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float b = (ev[0][k] * d[0] + ev[1][k] * d[1] + ev[2][k] * d[2]) / sigma[k];
      alpha[4 * i + 1 + k] = b;
      bsum += b;
    }
    alpha[4 * i] = 1.f - bsum;
  }
  __syncwarp();
  // M^T M over the weighted rows [a_c, 0, -a_c u] and [0, a_c, -a_c v] (c =
  // control point, xyz within), one entry a lane.
  for (int e = o.lane; e < 144; e += WARP) {
    const int a = e / 12, b = e % 12;
    const int ca = a / 3, xa = a % 3, cb = b / 3, xb = b % 3;
    float acc = 0.f;
    for (int i = 0; i < o.n; ++i) {
      const float w = o.w[i];
      const float u = (o.pt[2 * i] - o.cx) / o.fx, v = (o.pt[2 * i + 1] - o.cy) / o.fy;
      const float aa = alpha[4 * i + ca], ab = alpha[4 * i + cb];
      const float mua = xa == 0 ? aa : (xa == 1 ? 0.f : -aa * u);
      const float mub = xb == 0 ? ab : (xb == 1 ? 0.f : -ab * u);
      const float mva = xa == 0 ? 0.f : (xa == 1 ? aa : -aa * v);
      const float mvb = xb == 0 ? 0.f : (xb == 1 ? ab : -ab * v);
      acc += (w * mua) * (w * mub) + (w * mva) * (w * mvb);
    }
    sa[e] = acc;
  }
  __syncwarp();
  jacobi12(sa, sv, order, o.lane);
  // The four smallest eigenvectors, [k][control][xyz], and their control-point
  // differences over the six pairs, [k][pair][xyz].
  for (int e = o.lane; e < 48; e += WARP) vnull[e] = sv[(e % 12) * 12 + order[e / 12]];
  __syncwarp();
  for (int e = o.lane; e < 72; e += WARP) {
    const int k = e / 18, p = (e / 3) % 6, x = e % 3;
    dv[e] = vnull[k * 12 + PAIR_I[p] * 3 + x] - vnull[k * 12 + PAIR_J[p] * 3 + x];
  }
  __syncwarp();

  float dist2[6], g[6][6];                      // g: gram(a, b) per pair, (a, b) as below
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int i = p < 3 ? 0 : (p < 5 ? 1 : 2);
    const int j = p < 3 ? p + 1 : (p < 5 ? p - 1 : 3);
    float s = 0.f;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float d = ctrl_w[i][x] - ctrl_w[j][x];
      s += d * d;
    }
    dist2[p] = s;
  }
  // gram pairs: 0:(0,0) 1:(0,1) 2:(1,1) 3:(0,2) 4:(1,2) 5:(2,2)
  const int ga[6] = {0, 0, 1, 0, 1, 2}, gb[6] = {0, 1, 1, 2, 2, 2};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const float* da = dv + (ga[q] * 6 + p) * 3;
      const float* db = dv + (gb[q] * 6 + p) * 3;
      g[q][p] = da[0] * db[0] + da[1] * db[1] + da[2] * db[2];
    }
  }

  float betas[3][4];
  {  // N = 1
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      num += dist2[p] * g[0][p];
      den += g[0][p] * g[0][p];
    }
    betas[0][0] = sqrtf(fabsf(num) / fmaxf(den, 1e-12f));
    betas[0][1] = betas[0][2] = betas[0][3] = 0.f;
  }
  {  // N = 2: unknowns [b11, b12, b22]
    float l[6][3], y[3];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      l[p][0] = g[0][p];
      l[p][1] = 2.f * g[1][p];
      l[p][2] = g[2][p];
    }
    betas_ls<3>(l, dist2, y);
    betas[1][0] = sqrtf(fabsf(y[0]));
    betas[1][1] = sqrtf(fabsf(y[2])) * sign_of(y[1]) * sign_of(y[0] + 1e-30f);
    betas[1][2] = betas[1][3] = 0.f;
  }
  {  // N = 3: unknowns [b11, b12, b22, b13, b23, b33]
    float l[6][6], y[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      l[p][0] = g[0][p];
      l[p][1] = 2.f * g[1][p];
      l[p][2] = g[2][p];
      l[p][3] = 2.f * g[3][p];
      l[p][4] = 2.f * g[4][p];
      l[p][5] = g[5][p];
    }
    betas_ls<6>(l, dist2, y);
    const float b1 = sqrtf(fabsf(y[0]));
    betas[2][0] = b1;
    betas[2][1] = sqrtf(fabsf(y[2])) * sign_of(y[1]) * sign_of(y[0] + 1e-30f);
    betas[2][2] = y[3] / (fabsf(b1) < 1e-12f ? 1e-12f : b1);
    betas[2][3] = 0.f;
  }

  float sw[3] = {0.f, 0.f, 0.f};                // weighted world centroid
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3];
    o.corner(i, x3);
    const float w = o.w[i];
#pragma unroll
    for (int x = 0; x < 3; ++x) sw[x] += x3[x] * w;
  }
  warp_sum(sw);
  float mu_w[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) mu_w[x] = sw[x] / fmaxf(wsum, 1e-9f);

  // Each seed refined, scored by its reprojection error; the first least
  // (a NaN error wins, as argmin takes it) gives the pose.
  gauss_newton(dv, dist2, betas[0]);
  Hypothesis best = score_betas(o, alpha, vnull, betas[0], mu_w, wsum);
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    gauss_newton(dv, dist2, betas[k]);
    const Hypothesis hy = score_betas(o, alpha, vnull, betas[k], mu_w, wsum);
    if (!isnan(best.err) && (isnan(hy.err) || hy.err < best.err)) best = hy;
  }
  // Weighted Procrustes: R maximises tr(R h) = tr(R^T h^T).
  const float m[9] = {best.h[0], best.h[3], best.h[6], best.h[1], best.h[4],
                      best.h[7], best.h[2], best.h[5], best.h[8]};
  Pose out;
  nearest_rotation(m, out.r);
  float rm[3];
  rotate(out.r, mu_w, rm);
#pragma unroll
  for (int x = 0; x < 3; ++x) out.t[x] = best.mu_c[x] - rm[x];
  return out;
}

// ------------------------------------------------------------------- LM
// Weighted squared pixel reprojection error of pose (r, t).
__device__ float lm_cost(const Obj& o, const float (&r)[9], const float (&t)[3]) {
  float acc = 0.f;
  for (int i = o.lane; i < o.n; i += WARP) {
    float x3[3], q[3];
    o.corner(i, x3);
    rotate(r, x3, q);
    const float z = safe_z(q[2] + t[2]);
    const float w = o.w[i];
    const float du = (o.fx * (q[0] + t[0]) / z + o.cx - o.pt[2 * i]) * w;
    const float dv = (o.fy * (q[1] + t[1]) / z + o.cy - o.pt[2 * i + 1]) * w;
    acc += du * du + dv * dv;
  }
  return warp_sum(acc);
}

__device__ void lm_refine(const Obj& o, Pose& pose) {
  float lam = 1e-3f;
  float best = lm_cost(o, pose.r, pose.t);
  for (int it = 0; it < LM_ITERS; ++it) {
    // J^T J (upper triangle, 21) and J^T r (6) at the current pose.
    float acc[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) acc[k] = 0.f;
    for (int i = o.lane; i < o.n; i += WARP) {
      float x3[3], q[3];
      o.corner(i, x3);
      rotate(pose.r, x3, q);
      const float pcx = q[0] + pose.t[0], pcy = q[1] + pose.t[1];
      const float z = safe_z(q[2] + pose.t[2]);
      const float zi = 1.f / z;
      const float w = o.w[i];
      const float du[3] = {o.fx * zi, 0.f, -o.fx * pcx * zi * zi};
      const float dv[3] = {0.f, o.fy * zi, -o.fy * pcy * zi * zi};
      // d pc / d[delta | t] = [-[q]x | I]
      float ju[6], jv[6];
      ju[0] = -du[1] * q[2] + du[2] * q[1];
      ju[1] = du[0] * q[2] - du[2] * q[0];
      ju[2] = -du[0] * q[1] + du[1] * q[0];
      jv[0] = -dv[1] * q[2] + dv[2] * q[1];
      jv[1] = dv[0] * q[2] - dv[2] * q[0];
      jv[2] = -dv[0] * q[1] + dv[1] * q[0];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ju[3 + k] = du[k];
        jv[3 + k] = dv[k];
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        ju[k] *= w;
        jv[k] *= w;
      }
      const float ru = (o.fx * pcx / z + o.cx - o.pt[2 * i]) * w;
      const float rv = (o.fy * pcy / z + o.cy - o.pt[2 * i + 1]) * w;
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[e++] += ju[a] * ju[b] + jv[a] * jv[b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += ju[a] * ru + jv[a] * rv;
    }
    warp_sum(acc);
    float h[6][6], g[6];
    int e = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        h[a][b] = h[b][a] = acc[e++];
      }
      h[a][a] += lam;
      g[a] = acc[21 + a];
    }
    solve_gauss<6>(h, g);
    float dr[9], rc[9], tc[3];
    rodrigues(-g[0], -g[1], -g[2], dr);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rc[3 * i + j] = dr[3 * i] * pose.r[j] + dr[3 * i + 1] * pose.r[3 + j] + dr[3 * i + 2] * pose.r[6 + j];
      tc[i] = pose.t[i] - g[3 + i];
    }
    const float cand = lm_cost(o, rc, tc);
    const bool improved = cand < best;
    if (improved) {
#pragma unroll
      for (int k = 0; k < 9; ++k) pose.r[k] = rc[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) pose.t[k] = tc[k];
    }
    lam = fminf(fmaxf(improved ? lam / 3.f : lam * 10.f, 1e-10f), 1e10f);
    best = (isnan(cand) || isnan(best)) ? NAN : fminf(cand, best);
  }
}

// --------------------------------------------------------------- the kernel
__global__ void __launch_bounds__(WARP) pnp_kernel(const float* __restrict__ inputs,
                                                    float* __restrict__ outputs, int n,
                                                    int min_required) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const float* src = inputs + (size_t)blockIdx.x * (2 * n + TAIL);
  float* pt = smem;
  float* w = pt + 2 * n;
  float* cub = w + n;
  float* alpha = cub + 24;
  float* sa = alpha + 4 * n;
  float* sv = sa + 144;
  float* dv = sv + 144;
  float* vnull = dv + 72;
  int* order = reinterpret_cast<int*>(vnull + 48);

  float nv = 0.f;
  for (int i = lane; i < n; i += WARP) {
    const float x = src[2 * i], y = src[2 * i + 1];
    const float wi = (x > INVALID && y > INVALID) ? 1.f : 0.f;
    w[i] = wi;
    pt[2 * i] = wi > 0.f ? x : 0.f;
    pt[2 * i + 1] = wi > 0.f ? y : 0.f;
    nv += wi;
  }
  if (lane < 24) cub[lane] = src[2 * n + lane];
  const float n_valid = warp_sum(nv);
  __syncwarp();

  Obj o;
  o.pt = pt;
  o.w = w;
  o.cub = cub;
  o.fx = src[2 * n + 24];
  o.fy = src[2 * n + 25];
  o.cx = src[2 * n + 26];
  o.cy = src[2 * n + 27];
  o.n = n;
  o.reps = n / 8;
  o.lane = lane;

  Pose pose = n_valid >= DLT_MIN_POINTS ? dlt_init(o, sa, sv, order, n_valid)
                                        : epnp_init(o, alpha, sa, sv, dv, vnull, order, n_valid);
  lm_refine(o, pose);

  // Mean reprojection error over the valid points.
  float err = 0.f;
  for (int i = lane; i < n; i += WARP) {
    float x3[3], q[3];
    o.corner(i, x3);
    rotate(pose.r, x3, q);
    const float z = safe_z(q[2] + pose.t[2]);
    const float du = o.fx * (q[0] + pose.t[0]) / z + o.cx - pt[2 * i];
    const float dvv = o.fy * (q[1] + pose.t[1]) / z + o.cy - pt[2 * i + 1];
    err += sqrtf(du * du + dvv * dvv) * w[i];
  }
  err = warp_sum(err) / fmaxf(n_valid, 1.f);

  float* dst = outputs + (size_t)blockIdx.x * RESULT_WIDTH;
  if (lane < 8) {                             // the cuboid's corners projected
    float x3[3] = {cub[3 * lane], cub[3 * lane + 1], cub[3 * lane + 2]}, q[3];
    rotate(pose.r, x3, q);
    const float z = safe_z(q[2] + pose.t[2]);
    dst[33 + 2 * lane] = o.fx * (q[0] + pose.t[0]) / z + o.cx;
    dst[34 + 2 * lane] = o.fy * (q[1] + pose.t[1]) / z + o.cy;
  } else if (lane == 8) {
    // OpenGL: rows 0 and 1 of R (and t) swapped, row 2 negated.
    float rgl[9] = {pose.r[3], pose.r[4], pose.r[5], pose.r[0], pose.r[1],
                    pose.r[2], -pose.r[6], -pose.r[7], -pose.r[8]};
    dst[0] = (n_valid >= min_required && pose.t[2] > 0.f) ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      dst[1 + k] = pose.r[k];
      dst[17 + k] = rgl[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) dst[10 + k] = pose.t[k];
    rot_to_quat(pose.r, dst + 13);
    dst[26] = pose.t[1];
    dst[27] = pose.t[0];
    dst[28] = -pose.t[2];
    rot_to_quat(rgl, dst + 29);
    dst[49] = err;
  }
}

}  // namespace

// Bytes of dynamic shared memory a block takes at n points a row.
extern "C" int pnp_smem_bytes(int n) { return (int)(smem_floats(n) * sizeof(float)); }

// inputs [m, 2n + 28] and outputs [m, 50] as above. Launches one block of
// one warp a row on `stream`; allocates nothing, does not synchronise.
// Returns cudaGetLastError() after the launch (0 = ok), or -1 for an argument
// the kernel does not take.
extern "C" int pnp_launch(const void* inputs, void* outputs, int m, int n, int min_required,
                          void* stream) {
  if (m < 0 || n < 8 || n % 8 != 0 || n > MAX_POINTS || !inputs || !outputs) return -1;
  if (m == 0) return 0;
  pnp_kernel<<<m, WARP, smem_floats(n) * sizeof(float), reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inputs), static_cast<float*>(outputs), n, min_required);
  return (int)cudaGetLastError();
}
