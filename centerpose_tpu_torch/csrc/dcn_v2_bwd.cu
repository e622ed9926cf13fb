// DCNv2 backward (modulated deformable 3x3 convolution, stride 1, pad 1,
// dilation 1, one deformable group, NHWC, float32) for NVIDIA Hopper (sm_90a).
//
// Replaces the four TPU kernels of `centerpose_tpu/ops/dcn_bwd.py`:
//
//   dcn_v2_bwd_fused_launch   <- `_fused_kernel`   dX, d_offset, d_mask, dW
//   dcn_v2_bwd_dx_launch      <- `_dx_kernel`      dX alone (reads no x)
//   dcn_v2_bwd_dcoord_launch  <- `_dcoord_kernel`  d_offset, d_mask alone
//   dcn_v2_bwd_dw_launch      <- `_dw_kernel`      dW alone
//
// and computes what they compute. With p_t = (h - 1 + i + dy_t, w - 1 + j +
// dx_t) for tap t = 3 i + j, v00..v11 the four corners of x around p_t (0
// outside the image), fy = py - floor(py), fx likewise, m_t the gate and
//
//   gs_t[c]   = sum_co W[t, c, co] * dout[co]        (per pixel)
//   bil_t[c]  = (1-fy)(1-fx) v00 + (1-fy) fx v01 + fy (1-fx) v10 + fy fx v11
//
// the terms are
//
//   dX[corner] += (bilinear weight of the corner) * m_t * gs_t
//   d_mask_t    = sum_c gs_t * bil_t
//   d_py_t      = m_t * sum_c gs_t * ((v10 - v00)(1-fx) + (v11 - v01) fx)
//   d_px_t      = m_t * sum_c gs_t * ((v01 - v00)(1-fy) + (v11 - v10) fy)
//   dW[t, c, :] = sum_pixels (m_t * bil_t[c]) * dout
//
// The coordinate derivative is the corner difference, also at integer
// coordinates (fy = 0 gives v10 - v00, never 0): a zero-initialised offset
// convolution starts exactly there and would otherwise never train.
// dbias = sum dout is left to the caller, as in the TPU package.
//
// It is not a carry-over of those kernels. Their one-hot selectors, lane
// packing, row blocks and resident [H, C, W] accumulators exist because a TPU
// cannot gather or scatter; here a corner's channels are one 16-byte load or
// one 16-byte vector atomic per thread from channel-contiguous memory.
//
// Layouts (contiguous unless a stride is given):
//   x [B,H,W,C]   offset [B,H,W,18] (pixel stride off_stride)
//   mask [B,H,W,9] (pixel stride mask_stride)   weight [9*C, Co]
//   dout [B,H,W,Co]   dX [B,H,W,C] (zeroed by the caller)
//   d_offset [B,H,W,18]   d_mask [B,H,W,9]   dW [9*C, Co] (zeroed by the caller)
// C and Co are multiples of 8; B, H, W are free.
//
// Design. One template, four instantiations. A block owns BM = 64 consecutive
// pixels and ONE tap (grid = pixel tiles x 9): nothing is shared between
// taps, and nine times the blocks fill the card on the small maps. The block
// first turns its 64 samples into a corner base index, four validity bits,
// fy, fx and the gate (coordinates in float32, summed in the order of the
// plain version, clamped to [-2, H+1] x [-2, W+1] before the int cast so that
// a huge offset lands where every corner is outside). Then, for each chunk of
// 64 input channels:
//   1. gs[64 pixels, 64 channels] = dout tile x W_t^T, contraction over Co in
//      steps of 32 through shared memory, each thread a 4 x 4 patch of FMAs;
//   2. the thread gathers the four corners of its 4 pixels x 4 channels (one
//      16-byte load each), and from that ONE gather and ONE gs patch feeds
//      the dX atomics (16-byte `atomicAdd(float4*)`, corners of weight 0 and
//      corners outside skipped), the three coordinate sums (kept in
//      registers over the channel chunks, reduced over the 16 threads of a
//      pixel with shuffles, written once: no atomics, deterministic) and the
//      column tile m * bil for dW in shared memory;
//   3. dW[64 channels, Co] += column tile^T x dout tile, contraction over the
//      block's 64 pixels, 64 output channels at a time, added to dW with
//      16-byte atomics.
// dX and dW are sums of atomics, so their last bits change from run to run;
// d_offset and d_mask do not.
//
// Bound on an H100: both products are 2 * B*HW * 9C * Co operations against
// tens of megabytes moved, so every production shape is bound by operations
// (67 TFLOP/s of float32 FMA). What the design does about it: one gather and
// one gs product serve three of the four terms, and no im2col or gs matrix
// ever exists in device memory. What it does not do yet: tensor cores (TF32
// or bf16 operands), a dout tile kept resident instead of re-read for every
// channel chunk, and a split of dW over scratch partials instead of atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // pixels per block
constexpr int BC = 64;   // input channels per step
constexpr int BK = 32;   // output channels per step of the gs product
constexpr int BN = 64;   // output channels per step of the dW product
constexpr int NT = 256;  // threads per block
constexpr int TAPS = 9;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// 16-byte vector atomic add to global memory (compute capability 9.x).
__device__ __forceinline__ void add4(float* p, float s, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(s * v[0], s * v[1], s * v[2], s * v[3]));
}

template <bool DX, bool DCOORD, bool DW>
__global__ void __launch_bounds__(NT)
dcn_v2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const float* __restrict__ wmat,
                  const float* __restrict__ dout, float* __restrict__ dx,
                  float* __restrict__ doffset, float* __restrict__ dmask,
                  float* __restrict__ dw, int B, int H, int W, int C, int Co,
                  long long off_stride, long long mask_stride) {
  constexpr bool GS = DX || DCOORD;      // needs gs = W_t . dout
  constexpr bool GATHER = DCOORD || DW;  // needs the corners of x

  __shared__ int2 s_pos[BM];     // .x corner-00 pixel index, .y validity bits
  __shared__ float4 s_par[BM];   // fy, fx, gate
  // As [BK][BM] + Bs [BK][BC] for the gs product, then Ds [BM][BN] for dW.
  __shared__ __align__(16) float s_ab[BM * BN];
  __shared__ __align__(16) float Cs[DW ? BM * BC : 4];   // columns [pixel][c]
  float* As = s_ab;
  float* Bs = s_ab + BK * BM;
  float* Ds = s_ab;

  const int tid = threadIdx.x;
  const int t = blockIdx.y;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int HW = H * W;

  if (tid < BM) {
    const long long p = m0 + tid;
    int2 pos = make_int2(0, 0);
    float4 par = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < M) {
      const int b = (int)(p / HW);
      const int r = (int)(p - (long long)b * HW);
      const int h = r / W;
      const int w = r - h * W;
      const float* op = offset + p * off_stride + 2 * t;
      float py = (float)(h - 1 + t / 3) + op[0];
      float px = (float)(w - 1 + t % 3) + op[1];
      // Clamp before the int cast: a clamped sample has every corner outside.
      py = fminf(fmaxf(py, -2.f), (float)(H + 1));
      px = fminf(fmaxf(px, -2.f), (float)(W + 1));
      const float fy0 = floorf(py);
      const float fx0 = floorf(px);
      const int y0 = (int)fy0, x0 = (int)fx0;
      const bool vy0 = (y0 >= 0) && (y0 < H), vy1 = (y0 + 1 >= 0) && (y0 + 1 < H);
      const bool vx0 = (x0 >= 0) && (x0 < W), vx1 = (x0 + 1 >= 0) && (x0 + 1 < W);
      pos.x = b * HW + y0 * W + x0;
      pos.y = (vy0 && vx0 ? 1 : 0) | (vy0 && vx1 ? 2 : 0) |
              (vy1 && vx0 ? 4 : 0) | (vy1 && vx1 ? 8 : 0);
      par = make_float4(py - fy0, px - fx0, mask[p * mask_stride + t], 0.f);
    }
    s_pos[tid] = pos;
    s_par[tid] = par;
  }
  __syncthreads();

  // Load role of both gs tiles: row gm (pixel / channel), 8 values from gc*8.
  const int gm = tid % BM;
  const int gc = tid / BM;          // 0 .. 3
  // Compute role: 4 x 4 patch; pixels ty*4.., channels tx*4.. of the chunk.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float psum[4][3];   // per pixel: sum_c gs*bil, gs*dbil/dy, gs*dbil/dx
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q) psum[i][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    // ---- 1. gs[pixel][c] = sum_co dout[pixel][co] * W[t*C + c][co] ----------
    float gs[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[i][j] = 0.f;
    if (GS) {
      for (int k0 = 0; k0 < Co; k0 += BK) {
        const int k = k0 + gc * 8;
        {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
          if (m0 + gm < M && k < Co) load8(dout + (size_t)(m0 + gm) * Co + k, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) As[(gc * 8 + i) * BM + gm] = v[i];
        }
        {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
          if (c0 + gm < C && k < Co)
            load8(wmat + ((size_t)t * C + c0 + gm) * Co + k, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) Bs[(gc * 8 + i) * BC + gm] = v[i];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(&As[kk * BM + ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk * BC + tx * 4]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) gs[i][j] = fmaf(a[i], b[j], gs[i][j]);
        }
        __syncthreads();
      }
    }

    // ---- 2. one gather, one gs patch: dX, coordinate sums, columns ----------
    const int c = c0 + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pl = ty * 4 + i;
      float col[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + pl < M && c < C) {
        const int2 pos = s_pos[pl];
        const float4 par = s_par[pl];
        const float fy = par.x, fx = par.y, mk = par.z;
        const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
        const float w10 = fy * (1.f - fx), w11 = fy * fx;
        const long long i00 = (long long)pos.x * C + c;
        const long long i01 = i00 + C;
        const long long i10 = i00 + (long long)W * C;
        const long long i11 = i10 + C;
        if (GATHER) {
          float v00[4] = {0.f, 0.f, 0.f, 0.f}, v01[4] = {0.f, 0.f, 0.f, 0.f};
          float v10[4] = {0.f, 0.f, 0.f, 0.f}, v11[4] = {0.f, 0.f, 0.f, 0.f};
          if (pos.y & 1) load4(x + i00, v00);
          if (pos.y & 2) load4(x + i01, v01);
          if (pos.y & 4) load4(x + i10, v10);
          if (pos.y & 8) load4(x + i11, v11);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bil = w00 * v00[j] + w01 * v01[j] + w10 * v10[j] + w11 * v11[j];
            if (DCOORD) {
              const float g = gs[i][j];
              psum[i][0] = fmaf(g, bil, psum[i][0]);
              psum[i][1] = fmaf(
                  g, (v10[j] - v00[j]) * (1.f - fx) + (v11[j] - v01[j]) * fx, psum[i][1]);
              psum[i][2] = fmaf(
                  g, (v01[j] - v00[j]) * (1.f - fy) + (v11[j] - v10[j]) * fy, psum[i][2]);
            }
            if (DW) col[j] = mk * bil;
          }
        }
        if (DX) {
          if ((pos.y & 1) && w00 * mk != 0.f) add4(dx + i00, w00 * mk, gs[i]);
          if ((pos.y & 2) && w01 * mk != 0.f) add4(dx + i01, w01 * mk, gs[i]);
          if ((pos.y & 4) && w10 * mk != 0.f) add4(dx + i10, w10 * mk, gs[i]);
          if ((pos.y & 8) && w11 * mk != 0.f) add4(dx + i11, w11 * mk, gs[i]);
        }
      }
      if (DW)
        *reinterpret_cast<float4*>(&Cs[pl * BC + tx * 4]) =
            make_float4(col[0], col[1], col[2], col[3]);
    }

    // ---- 3. dW[t*C + c][co] += sum_pixels col[pixel][c] * dout[pixel][co] ----
    if (DW) {
      for (int n0 = 0; n0 < Co; n0 += BN) {
        __syncthreads();   // Cs is written; the last readers of s_ab are done
#pragma unroll
        for (int r = 0; r < (BM * BN / 8) / NT; ++r) {
          const int piece = tid + r * NT;
          const int pl = piece >> 3;
          const int cg = (piece & 7) * 8;
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
          if (m0 + pl < M && n0 + cg < Co)
            load8(dout + (size_t)(m0 + pl) * Co + n0 + cg, v);
          float4* dst = reinterpret_cast<float4*>(&Ds[pl * BN + cg]);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < BM; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(&Cs[kk * BC + ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Ds[kk * BN + tx * 4]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        const int co = n0 + tx * 4;
        if (co < Co) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = c0 + ty * 4 + i;
            if (row < C) add4(dw + ((size_t)t * C + row) * Co + co, 1.f, acc[i]);
          }
        }
      }
      __syncthreads();   // before the next chunk overwrites s_ab and Cs
    }
  }

  // ---- coordinate sums: reduce over the 16 threads (tx) of each pixel -------
  if (DCOORD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float v = psum[i][q];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        psum[i][q] = v;
      }
      const int pl = ty * 4 + i;
      const long long p = m0 + pl;
      if (tx == 0 && p < M) {
        const float mk = s_par[pl].z;
        dmask[p * TAPS + t] = psum[i][0];
        doffset[p * 2 * TAPS + 2 * t] = mk * psum[i][1];
        doffset[p * 2 * TAPS + 2 * t + 1] = mk * psum[i][2];
      }
    }
  }
}

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = ok), or -1 for an argument the
// kernel does not take.
template <bool DX, bool DCOORD, bool DW>
int launch(const void* x, const void* offset, const void* mask,
           const void* weight, const void* dout, void* dx, void* doffset,
           void* dmask, void* dw, int B, int H, int W, int C, int Co,
           long long off_stride, long long mask_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0) return -1;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return -1;
  if (!offset || !mask || !dout) return -1;
  if ((DX || DCOORD) && !weight) return -1;
  if ((DCOORD || DW) && !x) return -1;
  if ((DX && !dx) || (DCOORD && (!doffset || !dmask)) || (DW && !dw)) return -1;
  const dim3 grid((unsigned)((M + BM - 1) / BM), TAPS);
  dcn_v2_bwd_kernel<DX, DCOORD, DW>
      <<<grid, dim3(NT), 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(offset),
          static_cast<const float*>(mask), static_cast<const float*>(weight),
          static_cast<const float*>(dout), static_cast<float*>(dx),
          static_cast<float*>(doffset), static_cast<float*>(dmask),
          static_cast<float*>(dw), B, H, W, C, Co, off_stride, mask_stride);
  return (int)cudaGetLastError();
}

}  // namespace

#define DCN_BWD_ARGS                                                          \
  const void *x, const void *offset, const void *mask, const void *weight,    \
      const void *dout, void *dx, void *doffset, void *dmask, void *dw, int B, \
      int H, int W, int C, int Co, long long off_stride,                      \
      long long mask_stride, void *stream
#define DCN_BWD_PASS                                                       \
  x, offset, mask, weight, dout, dx, doffset, dmask, dw, B, H, W, C, Co,   \
      off_stride, mask_stride, stream

// All four take the same arguments; a pointer the kernel does not use may be
// null (dx: x, doffset, dmask, dw; dcoord: dx, dw; dw: weight, dx, doffset,
// dmask).
extern "C" int dcn_v2_bwd_fused_launch(DCN_BWD_ARGS) {
  return launch<true, true, true>(DCN_BWD_PASS);
}
extern "C" int dcn_v2_bwd_dx_launch(DCN_BWD_ARGS) {
  return launch<true, false, false>(DCN_BWD_PASS);
}
extern "C" int dcn_v2_bwd_dcoord_launch(DCN_BWD_ARGS) {
  return launch<false, true, false>(DCN_BWD_PASS);
}
extern "C" int dcn_v2_bwd_dw_launch(DCN_BWD_ARGS) {
  return launch<false, false, true>(DCN_BWD_PASS);
}
