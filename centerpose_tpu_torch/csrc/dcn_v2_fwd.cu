// DCNv2 forward (modulated deformable 3x3 convolution, stride 1, pad 1,
// dilation 1, one deformable group) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `centerpose_tpu/ops/dcn_onehot.py::_grouped_kernel`
// (B1, body :237, called at :624; `dcn_v2_onehot(exact=False)`) and, through
// the same bodies, `_row_kernel` (B2, :97; `exact=True`), and computes what
// they compute:
//
//   out[b,h,w,:] = sum_t  W_t^T . ( m_t * bil(x[b], p_t) )  + bias
//   p_t = (h - 1 + i + dy_t,  w - 1 + j + dx_t),  t = 3*i + j
//
// exact for every offset; a bilinear corner outside the image counts 0 (B2's
// cut of taps beyond its VMEM row window is not reproduced). It is not a
// carry-over of those kernels: a TPU gathers slowly and has megabytes of fast
// memory, so they turn the gather into products against one-hot selectors;
// here a gather of a pixel's channels is one 16-byte load per thread from
// channel-contiguous (NHWC) memory, so the kernel gathers directly and keeps
// only the [9C, Co] contraction as a matrix product. No im2col matrix ever
// exists in device memory.
//
// Layouts (all contiguous unless a stride is given):
//   x      [B, H, W, C]     offset [B, H, W, 18] (pixel stride off_stride)
//   mask   [B, H, W, 9] (pixel stride mask_stride; post-sigmoid)
//   weight float:    [9*C, Co] (tap-major, then C: the HWIO weight flattened)
//          bfloat16: [Co, 9*C] (the same matrix transposed: K-major rows,
//                    the tensor cores' B operand)
//   bias   [Co]             out    [B, H, W, Co]
// float or __nv_bfloat16 operands, float accumulation, output in the operand
// type. C and Co are multiples of 8; B, H, W are free.
//
// Both bodies start alike: a block owns BM = 64 consecutive output pixels and
// turns each of its 64 x 9 (pixel, tap) samples into four corner pixel
// indices and four weights (bilinear weight x mask, 0 for a corner outside
// the image) in shared memory; coordinates are float32 and are clamped to
// [-2, H+1] x [-2, W+1] before the int cast, so a huge offset cannot
// overflow and lands where every corner is outside.
//
// float32 body: BN = 64 output channels, BK = 32 input channels per step;
// each thread gathers 8 channels of one pixel's four corners, blends them in
// float registers, and accumulates a 4 x 4 patch with plain FMAs (exact
// float32, as the float32 TPU path is).
//
// bfloat16 body. What bounds it on an H100: the 16 calls of one dlav1_34
// forward at 512x512, batch 8, need 113 GFLOP (0.115 ms at 989 TFLOP/s) and
// move about 330 MB once (0.099 ms at 3.35 TB/s): per call the C >= 128
// shapes are bound by operations, 128^2 C64->64 by bytes (40 MB, 12 us;
// 9.7 GFLOP, 9.8 us), 0.127 ms for the 16 calls. What the card actually
// spends is the gather: 4 corners x 128 bytes per (pixel, tap, 64 channels),
// 604 MB of L1 requests at 128^2 C64 batch 8, through the SM's one L1 /
// shared-memory pipe, which the column stores and the product's operand
// reads share. The design:
//   1. Tile per shape: BN = 64 output channels where Co <= 64 (10 of the 16
//      calls; no dead half), else 128; grid = pixel tiles x ceil(Co / BN),
//      never fewer blocks than a 64 x 128 tiling. 256 threads = two
//      warpgroups, each issuing wgmma.m64n{BN/2}k16 on its half of the tile.
//   2. A stage is one (tap, 64-channel chunk) step: A = the column tile
//      [64 px x 64 k] (8 KB) and B = the weight tile [BN x 64 k] (<= 16 KB),
//      both K-major with 128-byte rows in the 128-byte swizzle (16-byte
//      chunk c of row r at r*128 + (c ^ r%8)*16), in dynamic shared memory
//      aligned to 1024 bytes by hand; wgmma reads both through descriptors
//      (128B swizzle, stride 1024 bytes per 8 rows, +32 bytes per k16), so
//      no operand passes through registers.
//   3. A is produced in place: 8 threads on one pixel's 128-byte line, the
//      eight corner loads of two pixels issued before the float32 blend,
//      the column rounded to bf16 once and stored as one 16-byte chunk at
//      its swizzled address; fence.proxy.async makes these generic-proxy
//      stores (and the cp.async ones) visible to wgmma's async proxy.
//   4. B arrives by cp.async.cg, 16 bytes a copy, issued one step ahead into
//      a ring of 3 stages (93 KB with the corner tables at BN = 128, 69 KB at
//      BN = 64: two blocks per SM).
//   5. Overlap: the loop issues step s's wgmma group, then, while it runs,
//      copies step s+1's weights and gathers its columns into the buffer
//      step s-2 used; wgmma.wait_group 1 lets step s stay in flight, and one
//      block barrier per step guards the reuse.
//   6. Epilogue: bias, one rounding to bf16, 4-byte stores; the accumulator
//      layout is the m16n8 one per warp, indexed by constants only.
//   7. Tails: chunks past C and weight rows past Co are zero-filled
//      (cp.async with 0 source bytes, zero columns), pixels past B*H*W and
//      channels past Co are masked on store.
// What it does not do yet: split-K over taps or a persistent grid for the
// B = 1 maps (16-64 blocks on 132 SMs at 32^2 and 16^2), TMA for the weight
// tiles, and the float32 body on the tensor cores.

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

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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
// Both operand tiles are K-major with 128-byte rows (64 bf16 values), in the
// 128-byte swizzle: 16-byte chunk c of row r lives at r*128 + ((c ^ (r%8))*16)
// from a 1024-byte aligned base.
constexpr int TK = 64;        // input channels per step: one 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int STAGES = 3;     // ring of (column tile, weight tile) buffers

template <int BN>
struct Bf16Tile {
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int TABLE_BYTES = TAPS * BM * (int)(sizeof(int4) + sizeof(float4));
  // + 1024: the base is aligned by hand inside the dynamic allocation
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + TABLE_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (the column stores, cp.async) made
// visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle at
// shared address `addr` (1024-byte aligned; +32 bytes per k16 step): start
// address >> 4, leading byte offset 16 (unused by this layout), stride byte
// offset 1024 (from one 8-row group to the next), layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma (their registers change without it seeing so).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (f32, registers) += A[64 x 16] . B[16 x N], both bf16 from shared
// memory through descriptors, K-major. Accumulator layout: warp w of the
// warpgroup holds rows 16w .. 16w+15; with g = lane / 4, q = lane % 4,
// d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e] (the m16n8 accumulator
// layout of every 8 columns). Operands after the descriptors: accumulate
// (scale-d = 1), A and B unscaled, neither transposed (both K-major).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The weight tile of step (t, c0): rows co0 .. co0+BN-1 of [Co, 9C], k from
// t*C + c0, 64 values, 16 bytes per cp.async; rows past Co and chunks past C
// are written as zeros.
template <int BN>
__device__ __forceinline__ void load_weight_tile(const __nv_bfloat16* __restrict__ wt,
                                                 uint32_t b_tile, int co0, int Co,
                                                 int C, int t, int c0) {
  const size_t K9 = (size_t)TAPS * C;
#pragma unroll
  for (int i = 0; i < BN * 8 / NT; ++i) {
    const int piece = threadIdx.x + i * NT;
    const int n = piece >> 3;
    const int kc = piece & 7;
    const bool valid = (co0 + n < Co) && (c0 + kc * 8 < C);
    const __nv_bfloat16* src = valid ? wt + (co0 + n) * K9 + t * C + c0 + kc * 8 : wt;
    cp_async16(b_tile + sw128(n, kc), src, valid);
  }
}

// The column tile of step (t, c0): 8 threads per pixel, one 16-byte chunk
// each, pixels gp and gp + 32. All eight corner loads are issued before the
// blend; the blend is float32 and is rounded to bf16 once, as `gather8` does.
__device__ __forceinline__ void gather_tile(const __nv_bfloat16* __restrict__ x, int C,
                                            const int4* s_idx, const float4* s_wgt,
                                            int t, int c0, uint8_t* a_tile) {
  const int gp = threadIdx.x >> 3;
  const int chunk = threadIdx.x & 7;
  const int c = c0 + chunk * 8;
  const bool inside = c < C;
  uint4 raw[2][4];
  float w[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int4 id = s_idx[t * BM + gp + 32 * half];
    const float4 wg = s_wgt[t * BM + gp + 32 * half];
    const int idx[4] = {id.x, id.y, id.z, id.w};
    w[half][0] = wg.x; w[half][1] = wg.y; w[half][2] = wg.z; w[half][3] = wg.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      raw[half][k] = make_uint4(0u, 0u, 0u, 0u);
      if (inside && w[half][k] != 0.f)
        raw[half][k] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)idx[k] * C + c));
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t r[4] = {raw[half][k].x, raw[half][k].y, raw[half][k].z, raw[half][k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = fmaf(w[half][k], __uint_as_float(r[i] << 16), v[2 * i]);
        v[2 * i + 1] = fmaf(w[half][k], __uint_as_float(r[i] & 0xffff0000u), v[2 * i + 1]);
      }
    }
    const int row = gp + 32 * half;
    *reinterpret_cast<uint4*>(a_tile + sw128(row, chunk)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

template <int BN>
__global__ void __launch_bounds__(NT, 2)
dcn_v2_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ offset,
                       const __nv_bfloat16* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ wt,   // [Co, 9*C]
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       int B, int H, int W, int C, int Co,
                       long long off_stride, long long mask_stride) {
  using Tile = Bf16Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  int4* s_idx = reinterpret_cast<int4*>(smem + STAGES * Tile::STAGE_BYTES);
  float4* s_wgt = reinterpret_cast<float4*>(s_idx + TAPS * BM);

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int nsteps = TAPS * ((C + TK - 1) / TK);

  // The first weight tile needs no table: its copy runs under the corners.
  load_weight_tile<BN>(wt, smem_u32(smem + Tile::A_BYTES), co0, Co, C, 0, 0);
  cp_async_commit();
  sample_corners<__nv_bfloat16>(offset, mask, s_idx, s_wgt, m0, M, H, W,
                                off_stride, mask_stride);
  __syncthreads();
  gather_tile(x, C, s_idx, s_wgt, 0, 0, smem);

  // Two warpgroups, each on its half of the output tile: m64 x NW.
  constexpr int NW = BN / 2;
  const int wg = tid >> 7;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;

  int t = 0, c0 = 0;            // the step being multiplied
  for (int s = 0; s < nsteps; ++s) {
    // Step s's column tile and weight tile are complete and visible to the
    // async proxy; every wgmma before step s-1 has finished in both
    // warpgroups (each waited before this barrier).
    uint8_t* cur = smem + (s % STAGES) * Tile::STAGE_BYTES;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    const uint64_t da = sw128_desc(smem_u32(cur));
    const uint64_t db = sw128_desc(smem_u32(cur + Tile::A_BYTES + wg * NW * ROW_BYTES));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) Wgmma<NW>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    fence_acc(acc);
    // While it runs: step s+1 into the buffer step s-2 used.
    int tn = t, cn = c0 + TK;
    if (cn >= C) { cn = 0; ++tn; }
    if (s + 1 < nsteps) {
      uint8_t* nxt = smem + ((s + 1) % STAGES) * Tile::STAGE_BYTES;
      load_weight_tile<BN>(wt, smem_u32(nxt + Tile::A_BYTES), co0, Co, C, tn, cn);
      cp_async_commit();
      gather_tile(x, C, s_idx, s_wgt, tn, cn, nxt);
    }
    wgmma_wait<1>();            // step s-1 done; step s may stay in flight
    fence_acc(acc);
    t = tn;
    c0 = cn;
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // ---- epilogue: + bias, round to bf16 ---------------------------------------
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int row = ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = co0 + wg * NW + j * 8 + 2 * q;
    if (col < Co) {
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = m0 + row + 8 * h;
        if (p < M) {
          *reinterpret_cast<uint32_t*>(out + (size_t)p * Co + col) =
              pack_bf16(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
        }
      }
    }
  }
}

// Output channels per block of the bf16 kernel: no dead half for Co <= 64.
inline int bf16_block_n(int Co) { return Co <= 64 ? 64 : 128; }

template <int BN>
int launch_bf16(const dim3& grid, cudaStream_t s, const void* x, const void* offset,
                const void* mask, const void* weight, const void* bias, void* out,
                int B, int H, int W, int C, int Co, long long off_stride,
                long long mask_stride) {
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(dcn_v2_fwd_bf16_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Bf16Tile<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  dcn_v2_fwd_bf16_kernel<BN><<<grid, dim3(NT), Bf16Tile<BN>::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offset),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const __nv_bfloat16*>(weight),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), B, H,
      W, C, Co, off_stride, mask_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 kernel's plan for one call: plan[0..5] = pixels per block, output
// channels per block, grid x, grid y, dynamic shared memory in bytes, ring
// stages. Returns -1 for an argument the kernel does not take.
extern "C" int dcn_v2_fwd_bf16_plan(int B, int H, int W, int C, int Co, int* plan) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0) return -1;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return -1;
  const int bn = bf16_block_n(Co);
  plan[0] = BM;
  plan[1] = bn;
  plan[2] = (int)((M + BM - 1) / BM);
  plan[3] = (Co + bn - 1) / bn;
  plan[4] = bn == 64 ? Bf16Tile<64>::SMEM : Bf16Tile<128>::SMEM;
  plan[5] = STAGES;
  return 0;
}

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
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(gx, (unsigned)((Co + BN - 1) / BN));
    dcn_v2_fwd_f32_kernel<<<grid, dim3(NT), 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C,
        Co, off_stride, mask_stride);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const int bn = bf16_block_n(Co);
    const dim3 grid(gx, (unsigned)((Co + bn - 1) / bn));
    return bn == 64 ? launch_bf16<64>(grid, s, x, offset, mask, weight, bias, out, B,
                                      H, W, C, Co, off_stride, mask_stride)
                    : launch_bf16<128>(grid, s, x, offset, mask, weight, bias, out, B,
                                       H, W, C, Co, off_stride, mask_stride);
  }
  return -1;
}
