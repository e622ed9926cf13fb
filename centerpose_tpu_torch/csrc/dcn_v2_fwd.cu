// DCNv2 forward (modulated deformable 3x3 convolution, stride 1, pad 1,
// dilation 1, one deformable group) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `centerpose_tpu/ops/dcn_onehot.py::_grouped_kernel`
// (public function `dcn_v2_onehot(exact=False)`), and computes what it
// computes:
//
//   out[b,h,w,:] = sum_t  W_t^T . ( m_t * bil(x[b], p_t) )  + bias
//   p_t = (h - 1 + i + dy_t,  w - 1 + j + dx_t),  t = 3*i + j
//
// exact for every offset; a bilinear corner outside the image counts 0.
// It is not a carry-over of that kernel. The TPU kernel turns the gather into
// matrix products against one-hot selectors because a TPU gathers slowly and
// has megabytes of fast memory; here a gather of a pixel's channels is one or
// two 16-byte loads per thread from channel-contiguous (NHWC) memory, so the
// kernel gathers directly and keeps only the [9C, Co] contraction as a matrix
// product.
//
// Layouts (all contiguous unless a stride is given):
//   x      [B, H, W, C]     offset [B, H, W, 18] (pixel stride off_stride)
//   mask   [B, H, W, 9] (pixel stride mask_stride; post-sigmoid)
//   weight float:    [9*C, Co] (tap-major, then C: the HWIO weight flattened)
//          bfloat16: [Co, 9*C] (the same matrix transposed, so that a
//                    thread's two consecutive k of one output channel are
//                    one 32-bit word for the tensor-core fragment)
//   bias   [Co]             out    [B, H, W, Co]
// float or __nv_bfloat16 operands, float accumulation, output in the operand
// type. C and Co are multiples of 8; B, H, W are free.
//
// Design. One block owns a tile of BM = 64 consecutive output pixels and a
// tile of output channels. At its start the block turns each of its 64 x 9
// (pixel, tap) samples into four corner pixel indices and four weights
// (bilinear weight x mask, 0 for a corner outside the image) in shared
// memory; coordinates are float32 and are clamped to [-2, H+1] x [-2, W+1]
// before the int cast, so a huge offset cannot overflow and lands where every
// corner is outside. Then, for each tap and each chunk of input channels,
// every thread gathers 8 channels of one pixel's four corners (16-byte loads
// from channel-contiguous memory), blends them in float registers and writes
// its piece of the column tile to shared memory; the matching slice of the
// weight goes beside it; the product of the two tiles is accumulated in
// float registers. The epilogue adds the bias and writes the operand type.
// No im2col matrix ever exists in device memory.
//
//   float32:  BN = 64, BK = 32; each thread accumulates a 4 x 4 patch with
//             plain FMAs (exact float32, as the float32 TPU path is).
//   bfloat16: BN = 128, BK = 64; the blended columns are rounded to bf16
//             (the plain version rounds them at the same place) and the
//             product runs on the tensor cores with mma.sync.m16n8k16, 8
//             warps as 2 x 4, each owning 32 pixels x 32 channels. Rows of
//             both shared tiles are padded by 8 values so that fragment
//             loads hit 32 different banks.
//
// Bound on an H100: the 16 calls of one dlav1_34 forward at 512x512 do about
// 14.2 GFLOP per image in all, against a few tens of megabytes moved, so the
// large-C shapes are bound by operations and the C = 64 shapes sit near the
// bf16 tensor-core ridge. What the design does about it: the gather is fused
// with the product (bytes are read once, in 16-byte pieces), and the bf16
// product is on the tensor cores. What it does not do yet: wgmma, TMA for
// the weight tiles, and a pipeline that gathers the next column tile while
// the current one is multiplied; those are the next steps for this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int NT = 256;   // threads per block
constexpr int TAPS = 9;
// float32 kernel (FMA)
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per step
// bfloat16 kernel (mma.sync)
constexpr int TN = 128;   // output channels per block
constexpr int TK = 64;    // input channels per step
constexpr int TS = TK + 8;  // padded row of both shared tiles, in bf16 values

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Per (tap, pixel) of the block's pixel tile: four corner pixel indices and
// four weights (bilinear x mask; 0 where the corner is outside the image).
template <typename T>
__device__ __forceinline__ void sample_corners(
    const T* __restrict__ offset, const T* __restrict__ mask, int4* s_idx,
    float4* s_wgt, long long m0, long long M, int H, int W,
    long long off_stride, long long mask_stride) {
  const int HW = H * W;
  for (int q = threadIdx.x; q < TAPS * BM; q += NT) {
    const int t = q / BM;
    const int m = q - t * BM;
    const long long p = m0 + m;
    int4 id = make_int4(0, 0, 0, 0);
    float4 wg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < M) {
      const int b = (int)(p / HW);
      const int r = (int)(p - (long long)b * HW);
      const int h = r / W;
      const int w = r - h * W;
      const T* op = offset + p * off_stride + 2 * t;
      const float dy = to_float(op[0]);
      const float dx = to_float(op[1]);
      const float mk = to_float(mask[p * mask_stride + t]);
      float py = (float)(h - 1 + t / 3) + dy;
      float px = (float)(w - 1 + t % 3) + dx;
      // Clamp before the int cast: a clamped sample has every corner outside.
      py = fminf(fmaxf(py, -2.f), (float)(H + 1));
      px = fminf(fmaxf(px, -2.f), (float)(W + 1));
      const float fy0 = floorf(py);
      const float fx0 = floorf(px);
      const float fy = py - fy0;
      const float fx = px - fx0;
      const int y0 = (int)fy0, x0 = (int)fx0;
      const int y1 = y0 + 1, x1 = x0 + 1;
      const bool vy0 = (y0 >= 0) && (y0 < H), vy1 = (y1 >= 0) && (y1 < H);
      const bool vx0 = (x0 >= 0) && (x0 < W), vx1 = (x1 >= 0) && (x1 < W);
      const int base = b * HW;
      if (vy0 && vx0) { id.x = base + y0 * W + x0; wg.x = (1.f - fy) * (1.f - fx) * mk; }
      if (vy0 && vx1) { id.y = base + y0 * W + x1; wg.y = (1.f - fy) * fx * mk; }
      if (vy1 && vx0) { id.z = base + y1 * W + x0; wg.z = fy * (1.f - fx) * mk; }
      if (vy1 && vx1) { id.w = base + y1 * W + x1; wg.w = fy * fx * mk; }
    }
    s_idx[q] = id;
    s_wgt[q] = wg;
  }
}

// 8 channels (from channel c) of one sample: the four corners blended in
// float registers. A corner of weight 0 (outside, or masked out) is not read.
template <typename T>
__device__ __forceinline__ void gather8(const T* __restrict__ x, int C, int c,
                                        const int4& id, const float4& wg,
                                        float (&v)[8]) {
  float u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
  if (wg.x != 0.f) {
    load8(x + (size_t)id.x * C + c, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaf(wg.x, u[i], v[i]);
  }
  if (wg.y != 0.f) {
    load8(x + (size_t)id.y * C + c, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaf(wg.y, u[i], v[i]);
  }
  if (wg.z != 0.f) {
    load8(x + (size_t)id.z * C + c, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaf(wg.z, u[i], v[i]);
  }
  if (wg.w != 0.f) {
    load8(x + (size_t)id.w * C + c, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaf(wg.w, u[i], v[i]);
  }
}

// ---------------------------------------------------------------- float32
__global__ void __launch_bounds__(NT)
dcn_v2_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, const float* __restrict__ wmat,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int B, int H, int W, int C, int Co,
                      long long off_stride, long long mask_stride) {
  __shared__ int4 s_idx[TAPS * BM];     // corner pixel indices per (tap, pixel)
  __shared__ float4 s_wgt[TAPS * BM];   // corner weights x mask (0 = skip)
  __shared__ __align__(16) float As[BK * BM];  // column tile, [k][pixel]
  __shared__ __align__(16) float Bs[BK * BN];  // weight tile, [k][co]

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;

  sample_corners<float>(offset, mask, s_idx, s_wgt, m0, M, H, W, off_stride, mask_stride);
  __syncthreads();

  // Gather role: pixel gm, channel group gc (8 channels) of the BK chunk.
  const int gm = tid % BM;
  const int gc = tid / BM;          // 0 .. BK/8 - 1
  // Weight-load role: row bk, 8 columns from bn.
  const int bk = tid >> 3;          // 0 .. 31
  const int bn = (tid & 7) * 8;     // 0 .. 56
  // Compute role: 4 x 4 patch at (ty*4, tx*4).
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < TAPS; ++t) {
    const int4 id = s_idx[t * BM + gm];
    const float4 wg = s_wgt[t * BM + gm];
    for (int c0 = 0; c0 < C; c0 += BK) {
      // ---- gather + blend: 8 channels of one pixel ------------------------
      {
        float v[8];
        const int c = c0 + gc * 8;
        if (c < C) {
          gather8<float>(x, C, c, id, wg, v);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) As[(gc * 8 + i) * BM + gm] = v[i];
      }
      // ---- weight slice [BK, BN] ------------------------------------------
      {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
        if (c0 + bk < C && co0 + bn < Co)
          load8(wmat + (size_t)(t * C + c0 + bk) * Co + co0 + bn, v);
        float4* dst = reinterpret_cast<float4*>(&Bs[bk * BN + bn]);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      // ---- [BM, BK] x [BK, BN] in registers -------------------------------
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k * BM + ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k * BN + tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // ---- epilogue: + bias ------------------------------------------------------
  const int col = co0 + tx * 4;
  if (col < Co) {
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bias[col + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long p = m0 + ty * 4 + i;
      if (p < M) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = acc[i][j] + bv[j];
        store4(out + (size_t)p * Co + col, o);
      }
    }
  }
}

// --------------------------------------------------------------- bfloat16
// D (16x8, f32) += A (16x16, bf16, row) x B (16x8, bf16, col). Lane l holds,
// with g = l / 4 and q = l % 4:
//   a0 = A[g][2q..2q+1]      a1 = A[g+8][2q..2q+1]
//   a2 = A[g][2q+8..2q+9]    a3 = A[g+8][2q+8..2q+9]
//   b0 = B[2q..2q+1][g]      b1 = B[2q+8..2q+9][g]
//   d0 = D[g][2q]  d1 = D[g][2q+1]  d2 = D[g+8][2q]  d3 = D[g+8][2q+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT)
dcn_v2_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ offset,
                       const __nv_bfloat16* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ wt,   // [Co, 9*C]
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       int B, int H, int W, int C, int Co,
                       long long off_stride, long long mask_stride) {
  __shared__ int4 s_idx[TAPS * BM];
  __shared__ float4 s_wgt[TAPS * BM];
  __shared__ __align__(16) __nv_bfloat16 As[BM * TS];  // columns, [pixel][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[TN * TS];  // weights, [co][k]

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * TN;
  const int K9 = TAPS * C;

  sample_corners<__nv_bfloat16>(offset, mask, s_idx, s_wgt, m0, M, H, W,
                                off_stride, mask_stride);
  __syncthreads();

  // Gather role: 8 neighbouring threads read the 8 x 16 bytes of one pixel's
  // chunk (one 128-byte line per corner), so a warp touches 4 lines per load
  // instruction; pixels gp and gp + 32.
  const int gp = tid >> 3;
  const int gk = (tid & 7) * 8;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wm = (warp >> 2) * 32;  // the warp's 32 pixels
  const int wn = (warp & 3) * 32;   // and 32 output channels of the tile

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int t = 0; t < TAPS; ++t) {
    int4 id[2];
    float4 wg[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      id[half] = s_idx[t * BM + gp + 32 * half];
      wg[half] = s_wgt[t * BM + gp + 32 * half];
    }
    for (int c0 = 0; c0 < C; c0 += TK) {
      // ---- gather + blend: 8 channels of two pixels, rounded to bf16 ------
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + gk < C) {
          float v[8];
          gather8<__nv_bfloat16>(x, C, c0 + gk, id[half], wg[half], v);
          packed.x = pack_bf16(v[0], v[1]);
          packed.y = pack_bf16(v[2], v[3]);
          packed.z = pack_bf16(v[4], v[5]);
          packed.w = pack_bf16(v[6], v[7]);
        }
        *reinterpret_cast<uint4*>(&As[(gp + 32 * half) * TS + gk]) = packed;
      }
      // ---- weight slice [TN, TK]: 1024 pieces of 8 values, 4 per thread ---
#pragma unroll
      for (int i = 0; i < (TN * TK / 8) / NT; ++i) {
        const int piece = tid + i * NT;
        const int n = piece >> 3;
        const int kc = (piece & 7) * 8;
        uint4 w8 = make_uint4(0u, 0u, 0u, 0u);
        if (co0 + n < Co && c0 + kc < C)
          w8 = __ldg(reinterpret_cast<const uint4*>(
              wt + (size_t)(co0 + n) * K9 + t * C + c0 + kc));
        *reinterpret_cast<uint4*>(&Bs[n * TS + kc]) = w8;
      }
      __syncthreads();
      // ---- [BM, TK] x [TK, TN] on the tensor cores ------------------------
      if (co0 + wn < Co) {
#pragma unroll
        for (int k0 = 0; k0 < TK; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const __nv_bfloat16* ap = &As[(wm + i * 16 + g) * TS + k0 + 2 * q];
            a[i][0] = *reinterpret_cast<const uint32_t*>(ap);
            a[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * TS);
            a[i][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
            a[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * TS + 8);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (co0 + wn + j * 8 < Co) {
              const __nv_bfloat16* bp = &Bs[(wn + j * 8 + g) * TS + k0 + 2 * q];
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
              for (int i = 0; i < 2; ++i)
                mma_bf16_16816(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: + bias, round to bf16 ---------------------------------------
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = co0 + wn + j * 8 + 2 * q;
    if (col < Co) {
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const long long p = m0 + wm + i * 16 + g + hrow * 8;
          if (p < M) {
            *reinterpret_cast<uint32_t*>(out + (size_t)p * Co + col) = pack_bf16(
                acc[i][j][2 * hrow] + b0, acc[i][j][2 * hrow + 1] + b1);
          }
        }
      }
    }
  }
}

}  // namespace

// dtype 0 = float32 (weight [9*C, Co]), 1 = bfloat16 (weight [Co, 9*C]).
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = ok), or -1 for an argument the
// kernel does not take.
extern "C" int dcn_v2_fwd_launch(const void* x, const void* offset,
                                 const void* mask, const void* weight,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, int Co, long long off_stride,
                                 long long mask_stride, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0) return -1;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return -1;
  const unsigned gx = (unsigned)((M + BM - 1) / BM);
  const dim3 block(NT);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(gx, (unsigned)((Co + BN - 1) / BN));
    dcn_v2_fwd_f32_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C,
        Co, off_stride, mask_stride);
  } else if (dtype == 1) {
    const dim3 grid(gx, (unsigned)((Co + TN - 1) / TN));
    dcn_v2_fwd_bf16_kernel<<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(offset),
        static_cast<const __nv_bfloat16*>(mask),
        static_cast<const __nv_bfloat16*>(weight),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), B, H, W, C, Co, off_stride,
        mask_stride);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
