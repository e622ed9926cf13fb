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
// Both bodies are built alike. A block owns BM = 64 consecutive output pixels
// and turns each of its (tap, pixel) samples into corner pixel indices and
// four weights (bilinear weight x mask, 0 for a corner outside the image) in
// shared memory; coordinates are float32 and are clamped to [-2, H+1] x
// [-2, W+1] before the int cast, so a huge offset cannot overflow and lands
// where every corner is outside. A step is one (tap, channel chunk): A = the
// column tile [64 px x one 128-byte row of channels] and B = the weight tile
// [BN x the same row], both K-major in the 128-byte swizzle (16-byte chunk c
// of row r at r*128 + (c ^ r%8)*16) in dynamic shared memory aligned to 1024
// bytes by hand; two warpgroups issue `wgmma` on their halves of the output
// tile, reading both operands through descriptors (128B swizzle, stride 1024
// bytes per 8 rows, +32 bytes per k-step), so no operand passes through
// registers. The loop issues step s's wgmma group, then, while it runs,
// copies step s+1's weight tile by cp.async.cg (16 bytes a copy; rows past Co
// and chunks past C arrive as zeros) and gathers its columns into a free
// buffer of a ring of stages; wgmma.wait_group and one block barrier per
// step guard the reuse, and fence.proxy.async makes the column stores (and
// the cp.async ones) visible to wgmma's async proxy. Columns are
// gathered 8 threads per pixel line, the eight corner loads of two pixels
// issued before the float32 blend. BN = 64 output channels where Co <= 64
// (no dead half), else 128. Pixels past B*H*W and channels past Co are
// masked on store.
//
// float32 body (B1 on the float32 train path, B2 on the float32 tracking
// path, one frame per call). What bounds it on an H100: the 16 calls of one
// dlav1_34 forward at 512x512, batch 8, need 113 GFLOP, 0.688 ms at the 165
// TFLOP/s of float32-accurate tensor-core products (3xTF32: three TF32
// products at 495 TFLOP/s), against about 660 MB moved once, 0.20 ms at
// 3.35 TB/s: operations bound every production shape. The FMA units (67
// TFLOP/s) could not reach it, so the body runs on the tensor cores:
//   1. 3xTF32. Every operand is held as hi = rna_tf32(v) and lo =
//      rna_tf32(v - hi) tiles, and each k8 slice issues
//      wgmma.m64n{BN/2}k8.f32.tf32.tf32 three times: lo.hi, hi.lo, hi.hi
//      (the dropped lo.lo and the roundings are ~2^-22 of a term; one TF32
//      product, ~2^-11, misses the float32 tolerance). A step is 32 channels
//      (one 128-byte row of floats), four k8 slices, twelve wgmma per
//      warpgroup into a step accumulator that starts from zero; once the
//      step is done it is added to the float32 sum in registers, rounded to
//      nearest. The tensor cores' own accumulation truncates, and over a
//      whole K loop of 3 K / 8 products on one accumulator that cost 10x the
//      error of the FMA body (5.7e-5 against 7e-6 at 32^2 C256, batch 8);
//      per step it costs nothing measurable. The split is made once, where
//      an operand is written: the columns are blended in float32 registers
//      and stored as hi and lo chunks; the weight, [9C, Co] as the caller
//      keeps it (and the backward reads it), is split and transposed to a
//      K-major [2, Co, 9C] copy by a small kernel at the start of every call
//      (at most 4.7 MB read), whose tiles the ring brings by cp.async.
//   2. What the card spends is the gather: 4 corners x 128 bytes per (pixel,
//      tap, 32 channels), 1.2 GB of corner lines at 128^2 C64 batch 8, which
//      arrive at about 4.4 TB/s (the bf16 body's gather, half the bytes, at
//      about 5.5), so the ring is sized for two blocks per SM at both widths,
//      whose gathers overlap each other's products: 2 stages of 16 KB of
//      columns (hi + lo) and 16 KB (BN = 64) or 32 KB (BN = 128) of weight,
//      with 11.25 KB of corner tables (one corner index and four weights per
//      sample), 76.25 or 108.25 KB. A step's products stay in flight while
//      the next step is gathered into the other buffer, and are waited for
//      before the next barrier. Steps go chunk-major (the 9 taps of one
//      32-channel chunk, then the next), so that consecutive steps meet the
//      same channel lines of neighbouring pixels.
//   3. A split of the K loop where the grid is small. When pixel tiles x
//      channel tiles fall short of one wave of 132 SMs (B = 1 at 64^2 and
//      below, B = 8 at 16^2 512->256), the 9 * ceil(C / 32) steps are cut
//      into S ranges of at least 4 steps, one per grid z; each range writes
//      a float32 partial to scratch [S, M, Co] and a second small kernel adds
//      them in a fixed order, plus the bias: the same bits in every call, no
//      atomics. A block of a range computes the corner tables of its taps
//      only. With S = 1 the epilogue adds the bias and stores.
// The plan (tile, grid, split, shared memory, scratch) is
// `dcn_v2_fwd_f32_plan`, mirrored by `ops/dcn_fwd.py::f32_plan`.
//
// bfloat16 body. What bounds it on an H100: the 16 calls of one dlav1_34
// forward at 512x512, batch 8, need 113 GFLOP (0.115 ms at 989 TFLOP/s) and
// move about 330 MB once (0.099 ms at 3.35 TB/s): per call the C >= 128
// shapes are bound by operations, 128^2 C64->64 by bytes (40 MB, 12 us;
// 9.7 GFLOP, 9.8 us), 0.127 ms for the 16 calls. What the card actually
// spends is the gather: 4 corners x 128 bytes per (pixel, tap, 64 channels),
// 604 MB of L1 requests at 128^2 C64 batch 8, through the SM's one L1 /
// shared-memory pipe, which the column stores and the product's operand
// reads share. The design, beyond what both bodies share:
//   1. Tile per shape: grid = pixel tiles x ceil(Co / BN), never fewer blocks
//      than a 64 x 128 tiling; wgmma.m64n{BN/2}k16 per warpgroup.
//   2. A step is 64 channels: A [64 px x 64 k] (8 KB), B [BN x 64 k]
//      (<= 16 KB); the column is rounded to bf16 once and stored as one
//      16-byte chunk at its swizzled address.
//   3. The ring of 3 stages is 93 KB with the corner tables at BN = 128, 69 KB
//      at BN = 64: two blocks per SM.
//   4. Epilogue: bias, one rounding to bf16, 4-byte stores; the accumulator
//      layout is the m16n8 one per warp, indexed by constants only.
// What neither body does yet: a persistent grid, TMA for the weight tiles,
// reuse of a corner's line across the taps of a block beyond what L1 keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int NT = 256;   // threads per block
constexpr int TAPS = 9;
constexpr int ROW_BYTES = 128;   // one K-major operand row: the 128-byte swizzle's span

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` of a tile in the 128-byte
// swizzle, from a 1024-byte aligned base.
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
// shared address `addr` (1024-byte aligned; +32 bytes per k-step): start
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

// ---------------------------------------------------------------- float32
constexpr int F32_BK = 32;          // input channels per step: one 128-byte row
constexpr int F32_MIN_RANGE = 4;    // least steps in one range of a split K loop
constexpr int F32_SMS = 132;        // an H100's SMs: a split grid fills one wave

// Ring of (column, weight) hi + lo buffers: every product is waited for
// within its own step, so the buffer a step fills is one step old.
constexpr int F32_STAGES = 2;

template <int BN>
struct F32Tile {
  static constexpr int A_BYTES = BM * ROW_BYTES;    // one of hi, lo
  static constexpr int B_BYTES = BN * ROW_BYTES;
  // [A hi | A lo | B hi | B lo], each 1024-byte aligned
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int TABLE_BYTES = TAPS * BM * (int)(sizeof(float4) + sizeof(int));
  // + 1024: the base is aligned by hand inside the dynamic allocation
  static constexpr int SMEM = 1024 + F32_STAGES * STAGE_BYTES + TABLE_BYTES;
};

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - hi);
}

// D[64 x N] (f32, registers) = A[64 x 8] . B[8 x N] (+ D where `accumulate`),
// both TF32 from shared memory through descriptors, K-major (the only layout
// TF32 takes); the accumulator layout is the bf16 one's (below). Operands
// after the descriptors: scale-d = accumulate, A and B unscaled.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

struct F32Args {
  const float* x;
  const float* offset;
  const float* mask;
  const float* ws;       // [2, Co, 9C]: the weight's hi, then its lo, K-major
  const float* bias;
  float* out;            // split 1: the output; else the partials [split, M, Co]
  int B, H, W, C, Co;
  long long off_stride, mask_stride;
  int split;
};

// Per (tap, pixel) of the block's pixel tile, for taps t0 .. t1-1: the
// pixel index of the corner (y0, x0) (the others are +1, +W, +W+1) and the
// four weights, bilinear x mask, 0 where the corner is outside the image.
__device__ __forceinline__ void f32_corners(const F32Args& a, int* s_base, float4* s_wgt,
                                            long long m0, long long M, int t0, int t1) {
  const int H = a.H, W = a.W, HW = H * W;
  for (int q = t0 * BM + threadIdx.x; q < t1 * BM; q += NT) {
    const int t = q / BM;
    const int m = q - t * BM;
    const long long p = m0 + m;
    int base = 0;
    float4 wg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < M) {
      const int b = (int)(p / HW);
      const int r = (int)(p - (long long)b * HW);
      const int h = r / W;
      const int w = r - h * W;
      const float* op = a.offset + p * a.off_stride + 2 * t;
      const float mk = a.mask[p * a.mask_stride + t];
      float py = (float)(h - 1 + t / 3) + op[0];
      float px = (float)(w - 1 + t % 3) + op[1];
      // Clamp before the int cast: a clamped sample has every corner outside.
      py = fminf(fmaxf(py, -2.f), (float)(H + 1));
      px = fminf(fmaxf(px, -2.f), (float)(W + 1));
      const float fy0 = floorf(py);
      const float fx0 = floorf(px);
      const float fy = py - fy0;
      const float fx = px - fx0;
      const int y0 = (int)fy0, x0 = (int)fx0;
      const bool vy0 = (y0 >= 0) && (y0 < H), vy1 = (y0 + 1 >= 0) && (y0 + 1 < H);
      const bool vx0 = (x0 >= 0) && (x0 < W), vx1 = (x0 + 1 >= 0) && (x0 + 1 < W);
      base = b * HW + y0 * W + x0;   // within int: the plan refuses M + 2W + 2 > INT_MAX
      if (vy0 && vx0) wg.x = (1.f - fy) * (1.f - fx) * mk;
      if (vy0 && vx1) wg.y = (1.f - fy) * fx * mk;
      if (vy1 && vx0) wg.z = fy * (1.f - fx) * mk;
      if (vy1 && vx1) wg.w = fy * fx * mk;
    }
    s_base[q] = base;
    s_wgt[q] = wg;
  }
}

// The column tile of step (t, c0), split: 8 threads per pixel, one 16-byte
// chunk (4 channels) each, pixels gp and gp + 32. All eight corner loads are
// issued before the float32 blend; a corner of weight 0 (outside, or masked
// out) is not read; the blend is split into hi and lo once and stored at the
// chunk's swizzled address in both tiles.
__device__ __forceinline__ void f32_gather_tile(const F32Args& a, const int* s_base,
                                                const float4* s_wgt, int t, int c0,
                                                uint8_t* a_hi, uint8_t* a_lo) {
  const int gp = threadIdx.x >> 3;
  const int chunk = threadIdx.x & 7;
  const int c = c0 + chunk * 4;
  const bool inside = c < a.C;
  const long long step[4] = {0, 1, a.W, a.W + 1};
  float4 raw[2][4];
  float w[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int base = s_base[t * BM + gp + 32 * half];
    const float4 wg = s_wgt[t * BM + gp + 32 * half];
    w[half][0] = wg.x; w[half][1] = wg.y; w[half][2] = wg.z; w[half][3] = wg.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      raw[half][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside && w[half][k] != 0.f)
        raw[half][k] = __ldg(reinterpret_cast<const float4*>(
            a.x + ((long long)base + step[k]) * a.C + c));
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 r = raw[half][k];
      v[0] = fmaf(w[half][k], r.x, v[0]);
      v[1] = fmaf(w[half][k], r.y, v[1]);
      v[2] = fmaf(w[half][k], r.z, v[2]);
      v[3] = fmaf(w[half][k], r.w, v[3]);
    }
    float4 hi, lo;
    split_tf32(v[0], hi.x, lo.x);
    split_tf32(v[1], hi.y, lo.y);
    split_tf32(v[2], hi.z, lo.z);
    split_tf32(v[3], hi.w, lo.w);
    const uint32_t o = sw128(gp + 32 * half, chunk);
    *reinterpret_cast<float4*>(a_hi + o) = hi;
    *reinterpret_cast<float4*>(a_lo + o) = lo;
  }
}

// The weight tiles (hi and lo) of step (t, c0): rows co0 .. co0+BN-1 of the
// [2, Co, 9C] split copy, k from t*C + c0, 32 values, 16 bytes per cp.async;
// rows past Co and chunks past C are written as zeros.
template <int BN>
__device__ __forceinline__ void f32_load_weight_tile(const F32Args& a, uint8_t* b_hi,
                                                     uint8_t* b_lo, int co0, int t, int c0) {
  const long long K9 = (long long)TAPS * a.C;
  const long long lo_part = (long long)a.Co * K9;
  const uint32_t hi_u32 = smem_u32(b_hi), lo_u32 = smem_u32(b_lo);
#pragma unroll
  for (int i = 0; i < BN * 8 / NT; ++i) {
    const int piece = threadIdx.x + i * NT;
    const int n = piece >> 3;
    const int kc = piece & 7;
    const bool valid = (co0 + n < a.Co) && (c0 + kc * 4 < a.C);
    const float* src = valid ? a.ws + (co0 + n) * K9 + (long long)t * a.C + c0 + kc * 4 : a.ws;
    cp_async16(hi_u32 + sw128(n, kc), src, valid);
    cp_async16(lo_u32 + sw128(n, kc), valid ? src + lo_part : a.ws, valid);
  }
}

template <int BN>
__global__ void __launch_bounds__(NT, 2)
dcn_v2_fwd_f32_kernel(const F32Args a) {
  using Tile = F32Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float4* s_wgt = reinterpret_cast<float4*>(smem + F32_STAGES * Tile::STAGE_BYTES);
  int* s_base = reinterpret_cast<int*>(s_wgt + TAPS * BM);

  const int tid = threadIdx.x;
  const long long M = (long long)a.B * a.H * a.W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int chunks = (a.C + F32_BK - 1) / F32_BK;
  const int nsteps = TAPS * chunks;
  // This block's range of (tap, chunk) steps: [s0, s1), never empty.
  const int s0 = (int)((long long)nsteps * blockIdx.z / a.split);
  const int s1 = (int)((long long)nsteps * (blockIdx.z + 1) / a.split);
  // Steps go chunk-major: the 9 taps of one 32-channel chunk one after
  // another, so that neighbouring taps meet the same channel lines in L1.
  int t = s0 % TAPS;                         // the step being multiplied
  int c0 = (s0 / TAPS) * F32_BK;
  // The taps of the range's steps: all of them once it wraps to a chunk.
  const bool wraps = s1 - s0 >= TAPS || (s1 - 1) % TAPS < t;
  const int t_lo = wraps ? 0 : t;
  const int t_hi = wraps ? TAPS : (s1 - 1) % TAPS + 1;

  // The first weight tile needs no table: its copy runs under the corners.
  f32_load_weight_tile<BN>(a, smem + 2 * Tile::A_BYTES, smem + 2 * Tile::A_BYTES + Tile::B_BYTES,
                           co0, t, c0);
  cp_async_commit();
  f32_corners(a, s_base, s_wgt, m0, M, t_lo, t_hi);
  __syncthreads();
  f32_gather_tile(a, s_base, s_wgt, t, c0, smem, smem + Tile::A_BYTES);

  // Two warpgroups, each on its half of the output tile: m64 x NW. A step's
  // products go to `acc`, from zero, and are added to `sum` in float32
  // round-to-nearest once the step is done: the tensor cores' accumulation
  // truncates, and over a whole K loop its error would grow with K.
  constexpr int NW = BN / 2;
  const int wg = tid >> 7;
  float acc[NW / 2], sum[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = 0.f;

  for (int s = s0; s < s1; ++s) {
    // Step s's column and weight tiles are complete and visible to the async
    // proxy; every earlier wgmma has finished in both warpgroups (each
    // waited before this barrier), so the other buffer is free.
    uint8_t* cur = smem + ((s - s0) % F32_STAGES) * Tile::STAGE_BYTES;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    const uint64_t da_hi = sw128_desc(smem_u32(cur));
    const uint64_t da_lo = sw128_desc(smem_u32(cur + Tile::A_BYTES));
    const uint8_t* b = cur + 2 * Tile::A_BYTES + wg * NW * ROW_BYTES;
    const uint64_t db_hi = sw128_desc(smem_u32(b));
    const uint64_t db_lo = sw128_desc(smem_u32(b + Tile::B_BYTES));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F32_BK / 8; ++kk) {
      // +32 bytes per k8: 2 in the descriptor's address field
      WgmmaTf32<NW>::mma(acc, da_lo + 2 * kk, db_hi + 2 * kk, kk > 0);
      WgmmaTf32<NW>::mma(acc, da_hi + 2 * kk, db_lo + 2 * kk, 1);
      WgmmaTf32<NW>::mma(acc, da_hi + 2 * kk, db_hi + 2 * kk, 1);
    }
    wgmma_commit();
    fence_acc(acc);
    int tn = t + 1, cn = c0;
    if (tn == TAPS) { tn = 0; cn += F32_BK; }
    // While it runs: step s+1 into the other buffer.
    if (s + 1 < s1) {
      uint8_t* nxt = smem + ((s + 1 - s0) % F32_STAGES) * Tile::STAGE_BYTES;
      f32_load_weight_tile<BN>(a, nxt + 2 * Tile::A_BYTES,
                               nxt + 2 * Tile::A_BYTES + Tile::B_BYTES, co0, tn, cn);
      cp_async_commit();
      f32_gather_tile(a, s_base, s_wgt, tn, cn, nxt, nxt + Tile::A_BYTES);
    }
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] += acc[i];
    t = tn;
    c0 = cn;
  }

  // ---- epilogue: + bias and store, or the range's partial ------------------
  const bool whole = a.split == 1;
  float* out = a.out + (whole ? 0 : (long long)blockIdx.z * M * a.Co);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int row = ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = co0 + wg * NW + j * 8 + 2 * q;
    if (col < a.Co) {
      const float b0 = whole ? a.bias[col] : 0.f;
      const float b1 = whole ? a.bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = m0 + row + 8 * h;
        if (p < M) {
          *reinterpret_cast<float2*>(out + p * a.Co + col) =
              make_float2(sum[4 * j + 2 * h] + b0, sum[4 * j + 2 * h + 1] + b1);
        }
      }
    }
  }
}

// ws[0][n][k] = hi(w[k][n]), ws[1][n][k] = lo(w[k][n]) for the [K9, Co]
// weight: a 32 x 32 tile transposed through shared memory, both sides
// coalesced. Block (32, 8).
__global__ void f32_weight_split_kernel(const float* __restrict__ w, float* __restrict__ ws,
                                        int K9, int Co) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = (k < K9 && n < Co) ? w[(long long)k * Co + n] : 0.f;
  }
  __syncthreads();
  const long long lo_part = (long long)Co * K9;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < Co && k < K9) {
      float hi, lo;
      split_tf32(tile[threadIdx.x][i], hi, lo);
      ws[(long long)n * K9 + k] = hi;
      ws[lo_part + (long long)n * K9 + k] = lo;
    }
  }
}

// out[i] = sum_{z < split} part[z][i] (z in order) + bias: deterministic.
// Counted in float4s; Co % 8 == 0 keeps each inside one pixel's row.
__global__ void f32_sum_partials_kernel(const float4* __restrict__ part,
                                        const float* __restrict__ bias,
                                        float4* __restrict__ out, long long n4, int Co,
                                        int split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < split; ++z) {
      const float4 v = part[z * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int co = (int)((i * 4) % Co);
    s.x += bias[co]; s.y += bias[co + 1]; s.z += bias[co + 2]; s.w += bias[co + 3];
    out[i] = s;
  }
}

struct F32Plan {
  int bn, gx, gy, split, smem, blocks_per_sm;
  long long weight_floats, partial_floats;
};

// Mirrored by `ops/dcn_fwd.py::f32_plan`; `chip_smoke.py` holds the two equal.
int f32_make_plan(int B, int H, int W, int C, int Co, F32Plan* p) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0) return -1;
  const long long M = (long long)B * H * W;
  if (M + 2LL * W + 2 > 0x7fffffffLL) return -1;   // corner indices are int
  p->bn = Co <= 64 ? 64 : 128;
  p->gx = (int)((M + BM - 1) / BM);
  p->gy = (Co + p->bn - 1) / p->bn;
  const int nsteps = TAPS * ((C + F32_BK - 1) / F32_BK);
  const long long base = (long long)p->gx * p->gy;
  p->split = 1;
  if (base < F32_SMS) {
    const int want = (int)((F32_SMS + base - 1) / base);
    const int most = nsteps / F32_MIN_RANGE;
    p->split = want < most ? want : most;
    if (p->split < 1) p->split = 1;
  }
  p->smem = p->bn == 64 ? F32Tile<64>::SMEM : F32Tile<128>::SMEM;
  p->blocks_per_sm = 2;                            // the kernel's launch bounds
  p->weight_floats = 2LL * TAPS * C * Co;
  p->partial_floats = p->split > 1 ? (long long)p->split * M * Co : 0;
  return 0;
}

int launch_weight_split(const float* w, float* ws, int C, int Co, cudaStream_t s) {
  const int K9 = TAPS * C;
  const dim3 grid((unsigned)((K9 + 31) / 32), (unsigned)((Co + 31) / 32));
  f32_weight_split_kernel<<<grid, dim3(32, 8), 0, s>>>(w, ws, K9, Co);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_f32(const F32Plan& p, const F32Args& a, cudaStream_t s) {
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(dcn_v2_fwd_f32_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, F32Tile<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid((unsigned)p.gx, (unsigned)p.gy, (unsigned)p.split);
  dcn_v2_fwd_f32_kernel<BN><<<grid, dim3(NT), F32Tile<BN>::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16
// Both operand tiles are K-major with 128-byte rows (64 bf16 values), in the
// 128-byte swizzle: 16-byte chunk c of row r lives at r*128 + ((c ^ (r%8))*16)
// from a 1024-byte aligned base.
constexpr int TK = 64;        // input channels per step: one 128-byte row
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
// blend; the blend is float32 and is rounded to bf16 once.
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

// The float32 kernel's plan for one call: plan[0..8] = pixels per block,
// output channels per block, grid x, grid y, split of the K loop (grid z),
// dynamic shared memory in bytes, ring stages, blocks per SM, scratch bytes
// (the weight's split copy + the partials where split > 1). Returns -1 for an
// argument the kernel does not take.
extern "C" int dcn_v2_fwd_f32_plan(int B, int H, int W, int C, int Co, long long* plan) {
  F32Plan p;
  if (f32_make_plan(B, H, W, C, Co, &p) != 0) return -1;
  const long long v[9] = {BM, p.bn, p.gx, p.gy, p.split, p.smem, F32_STAGES, p.blocks_per_sm,
                          4 * (p.weight_floats + p.partial_floats)};
  for (int i = 0; i < 9; ++i) plan[i] = v[i];
  return 0;
}

// float32: x, offset, mask, weight [9C, Co], bias, out as above; w_split
// [2, Co, 9C] and partials [split, M, Co] (partial_floats of them; may be
// null where the plan's split is 1) are the caller's scratch. Launches on
// `stream` the weight's split, the body and, where split > 1, the sum of the
// partials; allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 = ok), or -1 for an argument the kernel does not take.
extern "C" int dcn_v2_fwd_f32_launch(const void* x, const void* offset, const void* mask,
                                     const void* weight, const void* bias, void* out,
                                     void* w_split, void* partials, long long partial_floats,
                                     int B, int H, int W, int C, int Co,
                                     long long off_stride, long long mask_stride,
                                     void* stream) {
  F32Plan p;
  if (f32_make_plan(B, H, W, C, Co, &p) != 0) return -1;
  if (!x || !offset || !mask || !weight || !bias || !out || !w_split) return -1;
  if (p.partial_floats > 0 && (!partials || partial_floats < p.partial_floats)) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int err = launch_weight_split(static_cast<const float*>(weight), static_cast<float*>(w_split),
                                C, Co, s);
  if (err != 0) return err;
  F32Args a;
  a.x = static_cast<const float*>(x);
  a.offset = static_cast<const float*>(offset);
  a.mask = static_cast<const float*>(mask);
  a.ws = static_cast<const float*>(w_split);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(p.split > 1 ? partials : out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.Co = Co;
  a.off_stride = off_stride;
  a.mask_stride = mask_stride;
  a.split = p.split;
  err = p.bn == 64 ? launch_f32<64>(p, a, s) : launch_f32<128>(p, a, s);
  if (err != 0 || p.split == 1) return err;
  const long long n4 = (long long)B * H * W * Co / 4;
  const long long want = (n4 + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4LL * F32_SMS ? want : 4LL * F32_SMS);
  f32_sum_partials_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(partials),
                                                  static_cast<const float*>(bias),
                                                  static_cast<float4*>(out), n4, Co, p.split);
  return (int)cudaGetLastError();
}

// The weight's split copy alone (the first launch of `dcn_v2_fwd_f32_launch`),
// for timing it apart: w_split [2, Co, 9C] from weight [9C, Co].
extern "C" int dcn_v2_fwd_f32_weight_split(const void* weight, void* w_split, int C, int Co,
                                           void* stream) {
  if (C <= 0 || Co <= 0 || (C % 8) != 0 || (Co % 8) != 0 || !weight || !w_split) return -1;
  return launch_weight_split(static_cast<const float*>(weight), static_cast<float*>(w_split), C,
                             Co, reinterpret_cast<cudaStream_t>(stream));
}

// bfloat16 only (dtype 1; weight [Co, 9*C]): the float32 body has its own
// entry, `dcn_v2_fwd_f32_launch`, and dtype 0 returns -1. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = ok), or -1 for an argument the
// kernel does not take.
extern "C" int dcn_v2_fwd_launch(const void* x, const void* offset,
                                 const void* mask, const void* weight,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, int Co, long long off_stride,
                                 long long mask_stride, int dtype,
                                 void* stream) {
  if (dtype != 1) return -1;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0) return -1;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return -1;
  const unsigned gx = (unsigned)((M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int bn = bf16_block_n(Co);
  const dim3 grid(gx, (unsigned)((Co + bn - 1) / bn));
  return bn == 64 ? launch_bf16<64>(grid, s, x, offset, mask, weight, bias, out, B, H, W, C,
                                    Co, off_stride, mask_stride)
                  : launch_bf16<128>(grid, s, x, offset, mask, weight, bias, out, B, H, W, C,
                                     Co, off_stride, mask_stride);
}
