// DCNv2 backward (modulated deformable 3x3 convolution, stride 1, pad 1,
// dilation 1, one deformable group, NHWC, float32 or bfloat16 operands) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the four TPU kernels of `centerpose_tpu/ops/dcn_bwd.py`:
//
//   dcn_v2_bwd_fused_launch   <- `_fused_kernel`   dX, d_offset, d_mask, dW
//   dcn_v2_bwd_dx_launch      <- `_dx_kernel`      dX alone (reads no x)
//   dcn_v2_bwd_dcoord_launch  <- `_dcoord_kernel`  d_offset, d_mask alone
//   dcn_v2_bwd_dw_launch      <- `_dw_kernel`      dW alone
//
// (float32 operands) and `dcn_v2_bwd_{fused,dx,dcoord,dw}_bf16_launch`, the
// same four with bfloat16 operands: what those TPU kernels compute with
// `dt = bf16` (products of bf16 operands, float32 accumulators, mixed-
// precision training). With p_t = (h - 1 + i + dy_t, w - 1 + j +
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
// Layouts (contiguous unless a stride is given), T = float or bf16:
//   x [B,H,W,C] T   offset [B,H,W,18] T (pixel stride off_stride)
//   mask [B,H,W,9] T (pixel stride mask_stride)   weight [9*C, Co] T
//   dout [B,H,W,Co] T   dX [B,H,W,C] float32 (zeroed by the caller)
//   d_offset [B,H,W,18], d_mask [B,H,W,9], dW [9*C, Co]: float32
//   scratch: the float count `dcn_v2_bwd_plan` states (the caller allocates it)
// Every term is float32 whatever T is; the caller casts to the primal types.
// C and Co are multiples of 8, Co at most 256 (the caller splits a wider
// Co); B, H, W are free.
//
// Design. One template, four instantiations of terms and two operand types.
// float32 operands: every product is three TF32 `mma.sync.m16n8k8` (3xTF32),
// a = a_hi + a_lo with a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), and
// a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in float32 registers (the dropped
// a_lo.b_lo and the roundings are ~2^-22 of each term: one TF32 product is
// ~2^-11, too coarse for the gradient check). bfloat16 operands: each of
// those three products is one `mma.sync.m16n8k16.bf16` (float32
// accumulators) on operands that are bf16 already (x, W, dout) or rounded
// to bf16 where they are written (gs, the column tile m * bil), as the TPU
// kernel rounds them (`_gs_lanes(..., dt)`, `sampm.astype(dt)`); the dout
// tile is one bf16 copy, half the bytes of the float32 hi/lo pair. A block
// (256 threads, 8 warps)
// owns one tap, a slab of consecutive 64-pixel tiles and, with dW, NCH (1 or
// 2) chunks of 64 input channels, without dW every chunk (nothing is then
// accumulated over the slab); grid = slabs x 9 taps x channel groups, the
// slab count chosen per shape by the plan so that the grid fills the card.
// Per tile:
//   0. the corners of the tile's 64 samples (base index, validity bits, fy,
//      fx, gate) and the dout tile [64 px][Co] are put in shared memory, the
//      dout tile already split into hi / lo (float32) or as it is (bf16); it
//      stays there for every chunk of the block and serves both products;
//   1. per chunk, gs[px][c] = dout tile . W_t^T (K = Co), warps of 32 px x
//      16 c. The weight is read as ready-made B fragments (float32: hi, lo;
//      bf16: pairs along K) from a [9, C/8, K steps, 32 lanes] copy that a
//      small kernel of this file makes at the start of every call;
//   2. one gather of the four corners (16-byte loads, 8-byte for bf16) and one
//      gs patch per thread feed the dX atomics (16-byte vector `red`, float32
//      whatever T is; corners of weight 0 and corners outside skipped), the
//      three coordinate sums (registers, reduced over the 16 threads of a
//      pixel with shuffles, written once) and the column tile m * bil, split
//      into hi / lo in shared memory (bf16: rounded, stored transposed
//      [c][px] so that a B fragment pair along the pixels is one word);
//   3. dW_t^T[co][c] += dout tile^T . column tile (K = the tile's 64 pixels),
//      warps of 16*NCO co x 32 c, accumulated in registers over the whole
//      slab and written once per block.
// Float32 shared tiles are row-major with an XOR swizzle of bits 2-4 of the
// column (`swz`), so that both fragment orientations (row by lane/4, column by
// lane%4, and the transposed one) read 32 distinct banks; bf16 tiles XOR the
// 16-byte chunk of a row with the row (`swb`), for the same end.
// Sums across blocks are deterministic: each block writes its dW partial to
// scratch [slabs, 9C, Co] (or straight to dW for one slab), and its
// coordinate sums to [groups, M, 18 + 9] partials (or straight to the
// outputs for one channel group); a second small kernel adds the partials in
// a fixed order. So dW, d_offset and d_mask are the same bits in every run;
// dX is a sum of float atomics and is not (bf16 operands too: dX is summed
// in float32, a bf16 atomic would lose the sum).
//
// Bound on an H100: both products are 2 * B*HW * 9C * Co operations against
// tens of megabytes moved, so every production shape is bound by operations.
// Float32-accurate products on this card are the tensor cores' 3xTF32: three
// TF32 products at 495 TFLOP/s, an effective 165 TFLOP/s; bf16 products run
// at 989 TFLOP/s. What the card
// spends (`chip_smoke.py --clock`: cycles per 64-pixel tile of a block,
// PERF.md): the two product phases are about half of a tile at 128x128
// and more at the wider layers, and their time follows the count of
// mma.sync issued per SM sub-partition: 14-23 cycles per m16n8k8 TF32, a
// third or less of the data sheet's TF32 rate, so 3xTF32 through mma.sync
// runs near the float32 FMA rate; the gather, the tile's prologue and the
// coordinate sums are the rest. What the design does about it: one gather
// and one gs product for three of the four terms, the dout tile read from
// memory once per (tile, tap, channel group), no atomics for dW. What it
// does not do yet: issue the products as `wgmma` with whole K loops in
// flight (a version with both products on wgmma.m64n32k8, A from registers
// and a barrier per k-step, was right but no faster, PERF.md); the bf16
// body is the float32 one with one product in place of three, not yet
// made fast on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;    // pixels per tile
constexpr int BC = 64;    // input channels per chunk
constexpr int NT = 256;   // threads per block (8 warps)
constexpr int TAPS = 9;
constexpr int MAX_CO = 256;                      // widest Co one launch takes
constexpr long long SCRATCH_CAP = 16LL << 20;    // bytes of dW partials at most
constexpr int SM_SHARED = 228 * 1024;            // an H100 SM's shared memory
constexpr int BLOCK_RESERVED = 1024;             // kept by the SM per block

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// 4 consecutive bf16 (8 bytes) as floats: a bf16 is the top half of a float.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(a.x << 16); v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16); v[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

// 16-byte vector atomic add to global memory (compute capability 9.x).
__device__ __forceinline__ void add4(float* p, float s, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(s * v[0], s * v[1], s * v[2], s * v[3]));
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split1(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - hi);
}

__device__ __forceinline__ void split4(const float (&v)[4], float4& hi, float4& lo) {
  split1(v[0], hi.x, lo.x);
  split1(v[1], hi.y, lo.y);
  split1(v[2], hi.z, lo.z);
  split1(v[3], hi.w, lo.w);
}

// Two floats rounded to bf16 (to nearest even) in one word, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Column of element (row, col) of a shared tile whose row length is a
// multiple of 32 floats: bits 2-4 of the column XOR h(row % 8), h(q) =
// ((q & 3) << 1) | (q >> 2). A fragment read with the row by lane/4 and the
// column by lane%4 (or the other way round) then meets 32 distinct banks,
// and groups of 4 columns stay contiguous (16-byte stores).
__device__ __forceinline__ int swz(int row, int col) {
  const int q = row & 7;
  return col ^ ((((q & 3) << 1) | (q >> 2)) << 2);
}

// The same for a bf16 tile whose row length is a multiple of 64 elements:
// the 16-byte chunk (8 elements) of the column XOR row % 8. A word read with
// the row by lane/4 and two elements by lane%4 meets 32 distinct banks, and
// a chunk stays contiguous.
__device__ __forceinline__ int swb(int row, int col) { return col ^ ((row & 7) << 3); }

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32: the two small cross terms first, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d += a.b, bf16 operands, float32 accumulators: a = (row g, k 2tg..2tg+1),
// (g+8, 2tg..), (g, 2tg+8..), (g+8, 2tg+8..); b = (k 2tg..2tg+1, n g), (k
// 2tg+8.., n g); d as the TF32 product's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair16(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

struct BwdArgs {
  const void* x;         // T
  const void* offset;    // T
  const void* mask;      // T
  const void* wfrag;     // float32: float4 [9, C/8, Co/8, 32] (b0 hi, b1 hi, b0 lo, b1 lo);
                         // bf16: uint2 [9, C/8, ceil(Co/16), 32] (b0, b1)
  const void* dout;      // T
  float* dx;
  float* doffset;        // [groups, M, 18] (groups = 1: the output itself)
  float* dmask;          // [groups, M, 9]
  float* dw;             // [slabs, 9C, Co] (slabs = 1: the output itself)
  int B, H, W, C, Co;
  long long off_stride, mask_stride;
  int tiles, slabs;
  int nch;               // channel chunks per block (a template constant with dW)
  int cop, cop_log2;     // row length of the dout tile: 64, 128 or 256
};

template <typename T, bool DX, bool DCOORD, bool DW, int NCH, int NCO>
__global__ void __launch_bounds__(NT, !DW ? (NCO == 1 ? 3 : 2) : ((NCH * NCO <= 2) ? 2 : 1))
dcn_v2_bwd_kernel(const BwdArgs a) {
  constexpr bool BF = sizeof(T) == 2;    // bf16 operands
  constexpr bool GS = DX || DCOORD;      // needs gs = W_t . dout
  constexpr bool GATHER = DCOORD || DW;  // needs the corners of x

  extern __shared__ __align__(16) float smem[];
  const int cop = a.cop;
  // float32: dout tile hi / lo, then gs and the columns' hi, the columns' lo.
  float* d_hi = smem;                    // [BM][cop] dout tile, swizzled
  float* d_lo = d_hi + BM * cop;
  float* g_hi = d_lo + BM * cop;         // [BM][BC] gs, then the columns' hi
  float* g_lo = g_hi + BM * BC;          // the columns' lo (DW)
  // bf16: the dout tile, gs, the columns transposed.
  bf16* d_b = reinterpret_cast<bf16*>(smem);   // [BM][cop], swizzled (swb)
  bf16* gs_b = d_b + BM * cop;                 // [BM][BC] (GS)
  bf16* col_b = gs_b + (GS ? BM * BC : 0);     // [BC][BM] (DW)
  int2* s_pos = BF ? reinterpret_cast<int2*>(col_b + (DW ? BC * BM : 0))
                   : reinterpret_cast<int2*>(g_lo + (DW ? BM * BC : 0));   // corner 00, bits
  float4* s_par = reinterpret_cast<float4*>(s_pos + BM);     // fy, fx, gate

  const T* __restrict__ xg = static_cast<const T*>(a.x);
  const T* __restrict__ offg = static_cast<const T*>(a.offset);
  const T* __restrict__ maskg = static_cast<const T*>(a.mask);
  const T* __restrict__ doutg = static_cast<const T*>(a.dout);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int t = blockIdx.y;
  const int grp = blockIdx.z;
  const int C = a.C, Co = a.Co, W = a.W, H = a.H;
  const long long M = (long long)a.B * H * W;
  const int HW = H * W;
  const int tile0 = (int)((long long)a.tiles * blockIdx.x / a.slabs);
  const int tile1 = (int)((long long)a.tiles * (blockIdx.x + 1) / a.slabs);

  // Gather role: pixels ty*4 .. ty*4+3, channels tx*4 .. tx*4+3 of a chunk.
  const int tx = tid & 15, ty = tid >> 4;
  // gs product: warp tile 32 px x 16 c.
  const int gm = (warp >> 2) * 32, gn = (warp & 3) * 16;
  // dW product: warp tile 16*NCO co (m-tile i at co = i*64 + wco) x 32 c.
  const int wco = (warp & 3) * 16, wc = (warp >> 2) * 32;

  float acc[DW ? NCH : 1][DW ? NCO : 1][4][4];
#pragma unroll
  for (int h = 0; h < (DW ? NCH : 1); ++h)
#pragma unroll
    for (int i = 0; i < (DW ? NCO : 1); ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[h][i][j][k] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const long long m0 = (long long)tile * BM;
    __syncthreads();   // every reader of the previous tile's buffers is done

    // ---- 0. the tile's samples and its dout tile -----------------------------
    if (tid < BM) {
      const long long p = m0 + tid;
      int2 pos = make_int2(0, 0);
      float4 par = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < M) {
        const int b = (int)p / HW;                 // M < 2^31
        const int r = (int)p - b * HW;
        const int h = r / W;
        const int w = r - h * W;
        const T* op = offg + p * a.off_stride + 2 * t;
        float py = (float)(h - 1 + t / 3) + ldf(op);
        float px = (float)(w - 1 + t % 3) + ldf(op + 1);
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
        par = make_float4(py - fy0, px - fx0, ldf(maskg + p * a.mask_stride + t), 0.f);
      }
      s_pos[tid] = pos;
      s_par[tid] = par;
    }
    if constexpr (BF) {
      // 16-byte chunks of 8 channels, copied as they are (zeros past Co).
      const int qlog = a.cop_log2 - 3;          // chunks per row: cop / 8
      for (int i = tid; i < (BM * cop) >> 3; i += NT) {
        const int r = i >> qlog;
        const int c8 = (i & ((1 << qlog) - 1)) << 3;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M && c8 < Co)
          v = __ldg(reinterpret_cast<const uint4*>(doutg + (m0 + r) * Co + c8));
        *reinterpret_cast<uint4*>(d_b + r * cop + swb(r, c8)) = v;
      }
    } else {
      const int qlog = a.cop_log2 - 2;          // float4s per row: cop / 4
      for (int i = tid; i < (BM * cop) >> 2; i += NT) {
        const int r = i >> qlog;
        const int c4 = (i & ((1 << qlog) - 1)) << 2;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m0 + r < M && c4 < Co) load4(reinterpret_cast<const float*>(doutg) + (m0 + r) * Co + c4, v);
        float4 hi, lo;
        split4(v, hi, lo);
        const int o = r * cop + swz(r, c4);
        *reinterpret_cast<float4*>(d_hi + o) = hi;
        *reinterpret_cast<float4*>(d_lo + o) = lo;
      }
    }
    __syncthreads();

    float psum[4][3];   // per pixel: sum_c gs*bil, gs*dbil/dy, gs*dbil/dx
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q) psum[i][q] = 0.f;

#pragma unroll
    for (int ch = 0; ch < (DW ? NCH : a.nch); ++ch) {
      const int c0 = (grp * (DW ? NCH : a.nch) + ch) * BC;
      if (c0 < C) {   // the same for the whole block
        // ---- 1. gs[px][c] = sum_co dout[px][co] * W[t*C + c][co] -------------
        if (GS) {
          float gacc[2][2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) gacc[i][j][k] = 0.f;
          const int ctiles = C >> 3;
          if constexpr (BF) {
            const int ksteps = (Co + 15) >> 4;
            const uint2* wf = static_cast<const uint2*>(a.wfrag);
            for (int ks = 0; ks < ksteps; ++ks) {
              uint32_t b[2][2];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int ct = (c0 + gn + nt * 8) >> 3;
                uint2 v = make_uint2(0u, 0u);
                if (ct < ctiles) v = __ldg(wf + (((size_t)t * ctiles + ct) * ksteps + ks) * 32 + lane);
                b[nt][0] = v.x; b[nt][1] = v.y;
              }
              const int k0 = ks * 16 + 2 * tg, k1 = k0 + 8;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const int r0 = gm + mt * 16 + g, r1 = r0 + 8;
                const uint32_t av[4] = {lds32(d_b + r0 * cop + swb(r0, k0)), lds32(d_b + r1 * cop + swb(r1, k0)),
                                        lds32(d_b + r0 * cop + swb(r0, k1)), lds32(d_b + r1 * cop + swb(r1, k1))};
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma_bf16(gacc[mt][nt], av, b[nt][0], b[nt][1]);
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int r0 = gm + mt * 16 + g, r1 = r0 + 8;
                const int cc = gn + nt * 8 + 2 * tg;
                *reinterpret_cast<uint32_t*>(gs_b + r0 * BC + swb(r0, cc)) =
                    pack_bf16(gacc[mt][nt][0], gacc[mt][nt][1]);
                *reinterpret_cast<uint32_t*>(gs_b + r1 * BC + swb(r1, cc)) =
                    pack_bf16(gacc[mt][nt][2], gacc[mt][nt][3]);
              }
          } else {
            const int ksteps = Co >> 3;
            const float4* wf = static_cast<const float4*>(a.wfrag);
            for (int ks = 0; ks < ksteps; ++ks) {
              uint32_t bh[2][2], bl[2][2];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int ct = (c0 + gn + nt * 8) >> 3;
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (ct < ctiles) v = __ldg(wf + (((size_t)t * ctiles + ct) * ksteps + ks) * 32 + lane);
                bh[nt][0] = bits(v.x); bh[nt][1] = bits(v.y);
                bl[nt][0] = bits(v.z); bl[nt][1] = bits(v.w);
              }
              const int k0 = ks * 8 + tg, k1 = k0 + 4;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const int r0 = gm + mt * 16 + g, r1 = r0 + 8;
                const int o00 = r0 * cop + swz(r0, k0), o10 = r1 * cop + swz(r1, k0);
                const int o01 = r0 * cop + swz(r0, k1), o11 = r1 * cop + swz(r1, k1);
                const uint32_t ah[4] = {bits(d_hi[o00]), bits(d_hi[o10]), bits(d_hi[o01]), bits(d_hi[o11])};
                const uint32_t al[4] = {bits(d_lo[o00]), bits(d_lo[o10]), bits(d_lo[o01]), bits(d_lo[o11])};
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) mma3(gacc[mt][nt], ah, al, bh[nt], bl[nt]);
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int r0 = gm + mt * 16 + g, r1 = r0 + 8;
                const int cc = gn + nt * 8 + 2 * tg;
                *reinterpret_cast<float2*>(g_hi + r0 * BC + swz(r0, cc)) =
                    make_float2(gacc[mt][nt][0], gacc[mt][nt][1]);
                *reinterpret_cast<float2*>(g_hi + r1 * BC + swz(r1, cc)) =
                    make_float2(gacc[mt][nt][2], gacc[mt][nt][3]);
              }
          }
          __syncthreads();
        }

        // ---- 2. one gather, one gs patch: dX, coordinate sums, columns --------
        const int cl = tx * 4;
        const int c = c0 + cl;
        float colv[4][4];   // bf16: this thread's 4 px x 4 c of the column tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pl = ty * 4 + i;
          const int o = pl * BC + swz(pl, cl);
          float gsv[4] = {0.f, 0.f, 0.f, 0.f};
          if (GS) {
            if constexpr (BF) {
              const uint2 q = *reinterpret_cast<const uint2*>(gs_b + pl * BC + swb(pl, cl));
              gsv[0] = __uint_as_float(q.x << 16); gsv[1] = __uint_as_float(q.x & 0xffff0000u);
              gsv[2] = __uint_as_float(q.y << 16); gsv[3] = __uint_as_float(q.y & 0xffff0000u);
            } else {
              const float4 q = *reinterpret_cast<const float4*>(g_hi + o);
              gsv[0] = q.x; gsv[1] = q.y; gsv[2] = q.z; gsv[3] = q.w;
            }
          }
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
              if (pos.y & 1) load4(xg + i00, v00);
              if (pos.y & 2) load4(xg + i01, v01);
              if (pos.y & 4) load4(xg + i10, v10);
              if (pos.y & 8) load4(xg + i11, v11);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float bil = w00 * v00[j] + w01 * v01[j] + w10 * v10[j] + w11 * v11[j];
                if (DCOORD) {
                  const float gv = gsv[j];
                  psum[i][0] = fmaf(gv, bil, psum[i][0]);
                  psum[i][1] = fmaf(
                      gv, (v10[j] - v00[j]) * (1.f - fx) + (v11[j] - v01[j]) * fx, psum[i][1]);
                  psum[i][2] = fmaf(
                      gv, (v01[j] - v00[j]) * (1.f - fy) + (v11[j] - v10[j]) * fy, psum[i][2]);
                }
                if (DW) col[j] = mk * bil;
              }
            }
            if (DX) {
              if ((pos.y & 1) && w00 * mk != 0.f) add4(a.dx + i00, w00 * mk, gsv);
              if ((pos.y & 2) && w01 * mk != 0.f) add4(a.dx + i01, w01 * mk, gsv);
              if ((pos.y & 4) && w10 * mk != 0.f) add4(a.dx + i10, w10 * mk, gsv);
              if ((pos.y & 8) && w11 * mk != 0.f) add4(a.dx + i11, w11 * mk, gsv);
            }
          }
          if (DW) {
            if constexpr (BF) {
#pragma unroll
              for (int j = 0; j < 4; ++j) colv[i][j] = col[j];
            } else {
              // In place: this thread alone reads and writes these 4 columns.
              float4 hi, lo;
              split4(col, hi, lo);
              *reinterpret_cast<float4*>(g_hi + o) = hi;
              *reinterpret_cast<float4*>(g_lo + o) = lo;
            }
          }
        }
        if constexpr (BF && DW) {
          // Transposed: channel cl + j, pixels ty*4 .. ty*4+3 (8 bytes).
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cr = cl + j;
            *reinterpret_cast<uint2*>(col_b + cr * BM + swb(cr, ty * 4)) =
                make_uint2(pack_bf16(colv[0][j], colv[1][j]), pack_bf16(colv[2][j], colv[3][j]));
          }
        }

        // ---- 3. dW_t^T[co][c] += sum_px dout[px][co] * col[px][c] ---------------
        if (DW) {
          __syncthreads();   // the column tile is written
          if constexpr (BF) {
#pragma unroll
            for (int ks = 0; ks < BM / 16; ++ks) {
              const int p0 = ks * 16 + 2 * tg, p1 = p0 + 8;
              uint32_t b[4][2];
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int cc = wc + nt * 8 + g;
                b[nt][0] = lds32(col_b + cc * BM + swb(cc, p0));
                b[nt][1] = lds32(col_b + cc * BM + swb(cc, p1));
              }
#pragma unroll
              for (int mt = 0; mt < NCO; ++mt) {
                const int q0 = mt * 64 + wco + g, q1 = q0 + 8;
                const uint32_t av[4] = {
                    pair16(d_b + p0 * cop + swb(p0, q0), d_b + (p0 + 1) * cop + swb(p0 + 1, q0)),
                    pair16(d_b + p0 * cop + swb(p0, q1), d_b + (p0 + 1) * cop + swb(p0 + 1, q1)),
                    pair16(d_b + p1 * cop + swb(p1, q0), d_b + (p1 + 1) * cop + swb(p1 + 1, q0)),
                    pair16(d_b + p1 * cop + swb(p1, q1), d_b + (p1 + 1) * cop + swb(p1 + 1, q1))};
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[DW ? ch : 0][mt][nt], av, b[nt][0], b[nt][1]);
              }
            }
          } else {
#pragma unroll 2
            for (int ks = 0; ks < BM / 8; ++ks) {
              const int p0 = ks * 8 + tg, p1 = p0 + 4;
              uint32_t bh[4][2], bl[4][2];
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int cc = wc + nt * 8 + g;
                const int o0 = p0 * BC + swz(p0, cc), o1 = p1 * BC + swz(p1, cc);
                bh[nt][0] = bits(g_hi[o0]); bh[nt][1] = bits(g_hi[o1]);
                bl[nt][0] = bits(g_lo[o0]); bl[nt][1] = bits(g_lo[o1]);
              }
#pragma unroll
              for (int mt = 0; mt < NCO; ++mt) {
                const int q0 = mt * 64 + wco + g, q1 = q0 + 8;
                const int o00 = p0 * cop + swz(p0, q0), o10 = p0 * cop + swz(p0, q1);
                const int o01 = p1 * cop + swz(p1, q0), o11 = p1 * cop + swz(p1, q1);
                const uint32_t ah[4] = {bits(d_hi[o00]), bits(d_hi[o10]), bits(d_hi[o01]), bits(d_hi[o11])};
                const uint32_t al[4] = {bits(d_lo[o00]), bits(d_lo[o10]), bits(d_lo[o01]), bits(d_lo[o11])};
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma3(acc[DW ? ch : 0][mt][nt], ah, al, bh[nt], bl[nt]);
              }
            }
          }
        }
        __syncthreads();   // before the next chunk writes gs / the columns
      }
    }

    // ---- coordinate sums: reduce over the 16 threads (tx) of each pixel ------
    if (DCOORD) {
      float* dm = a.dmask + (size_t)grp * M * TAPS;
      float* doff = a.doffset + (size_t)grp * M * 2 * TAPS;
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
          dm[p * TAPS + t] = psum[i][0];
          doff[p * 2 * TAPS + 2 * t] = mk * psum[i][1];
          doff[p * 2 * TAPS + 2 * t + 1] = mk * psum[i][2];
        }
      }
    }
  }

  // ---- the slab's dW partial, written once -----------------------------------
  if (DW) {
    float* out = a.dw + (size_t)blockIdx.x * TAPS * C * Co;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int mt = 0; mt < NCO; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = (grp * NCH + ch) * BC + wc + nt * 8 + 2 * tg;   // even; C % 8 == 0
          const int q0 = mt * 64 + wco + g, q1 = q0 + 8;
          if (c < C) {
            float* row0 = out + ((size_t)t * C + c) * Co;
            float* row1 = row0 + Co;
            const float(&d)[4] = acc[DW ? ch : 0][DW ? mt : 0][nt];
            if (q0 < Co) { row0[q0] = d[0]; row1[q0] = d[1]; }
            if (q1 < Co) { row0[q1] = d[2]; row1[q1] = d[3]; }
          }
        }
  }
}

// The weight as ready-made B fragments of the gs product: wfrag[t][ct][ks]
// [lane] = (W[r][k] hi, W[r][k+4] hi, W[r][k] lo, W[r][k+4] lo) with r =
// t*C + ct*8 + lane/4 and k = ks*8 + lane%4.
__global__ void weight_fragments_kernel(const float* __restrict__ wmat, float4* __restrict__ wfrag,
                                        int C, int Co) {
  const int ksteps = Co >> 3;
  const long long n = (long long)TAPS * (C >> 3) * ksteps * 32;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i & 31);
    const long long f = i >> 5;                  // (t * C/8 + ct) * ksteps + ks
    const int ks = (int)(f % ksteps);
    const long long row = (f / ksteps) * 8 + (lane >> 2);   // t*C + ct*8 + g
    const int k = ks * 8 + (lane & 3);
    float h0, l0, h1, l1;
    split1(__ldg(wmat + row * Co + k), h0, l0);
    split1(__ldg(wmat + row * Co + k + 4), h1, l1);
    wfrag[i] = make_float4(h0, h1, l0, l1);
  }
}

// Its bf16 twin, K steps of 16: wfrag[t][ct][ks][lane] = (W[r][k], W[r][k+1]
// | W[r][k+8], W[r][k+9]) with r as above and k = ks*16 + 2 (lane%4); zero
// past Co (Co % 8 == 0, so a pair is either inside or past it).
__global__ void weight_fragments_bf16_kernel(const bf16* __restrict__ wmat, uint2* __restrict__ wfrag,
                                             int C, int Co) {
  const int ksteps = (Co + 15) >> 4;
  const long long n = (long long)TAPS * (C >> 3) * ksteps * 32;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i & 31);
    const long long f = i >> 5;
    const int ks = (int)(f % ksteps);
    const long long row = (f / ksteps) * 8 + (lane >> 2);
    const int k = ks * 16 + 2 * (lane & 3);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(wmat + row * Co);
    wfrag[i] = make_uint2(k < Co ? __ldg(w + k / 2) : 0u, k + 8 < Co ? __ldg(w + (k + 8) / 2) : 0u);
  }
}

// out[i] = sum_{j < k} part[j * n + i], j in order: deterministic.
struct SumJob {
  const float* part;
  float* out;
  long long n;
  int k;
};
struct SumJobs {
  SumJob job[3];
};

__global__ void sum_partials_kernel(const SumJobs jobs) {
  const SumJob j = jobs.job[blockIdx.y];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < j.n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = j.part[i];
    for (int q = 1; q < j.k; ++q) s += j.part[q * j.n + i];
    j.out[i] = s;
  }
}

// ------------------------------------------------------------------ the plan
enum Kind { FUSED = 0, DXK = 1, DCOORDK = 2, DWK = 3 };
enum DType { F32 = 0, BF16 = 1 };

struct Plan {
  int tiles, slabs, groups, nch, nco, smem, blocks_per_sm;
  long long wfrag_floats, dw_floats, coord_floats;
};

inline bool has_gs(int kind) { return kind != DWK; }
inline bool has_dw(int kind) { return kind == FUSED || kind == DWK; }
inline bool has_dcoord(int kind) { return kind == FUSED || kind == DCOORDK; }

// Mirrored by `ops/dcn_bwd.py::bwd_plan`; `chip_smoke.py` holds the two equal.
int make_plan(int kind, int dtype, int B, int H, int W, int C, int Co, int sms, Plan* p) {
  if (kind < 0 || kind > 3 || sms <= 0 || (dtype != F32 && dtype != BF16)) return -1;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return -1;
  if ((C % 8) != 0 || (Co % 8) != 0 || Co > MAX_CO) return -1;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffffLL) return -1;
  const int chunks = (C + BC - 1) / BC;
  p->tiles = (int)((M + BM - 1) / BM);
  p->nco = Co <= 64 ? 1 : (Co <= 128 ? 2 : 4);
  // Without dW nothing is accumulated over a slab: a block takes every chunk
  // (the dout tile read once per tile and tap, no coordinate partials).
  p->nch = !has_dw(kind) ? chunks : ((p->nco == 1 && chunks >= 2) ? 2 : 1);
  p->groups = (chunks + p->nch - 1) / p->nch;
  // float32: dout tile hi + lo, gs / columns hi, columns lo (dW); bf16: the
  // dout tile, gs (dX, coordinates), the columns (dW); then the samples.
  p->smem = 4 * (2 * BM * 64 * p->nco + (has_dw(kind) ? 2 : 1) * BM * BC) + BM * 24;
  if (dtype == BF16)
    p->smem = 2 * BM * (64 * p->nco + (has_gs(kind) ? BC : 0) + (has_dw(kind) ? BC : 0)) + BM * 24;
  const int by_smem = SM_SHARED / (p->smem + BLOCK_RESERVED);
  const int by_regs = !has_dw(kind) ? (p->nco == 1 ? 3 : 2) : (p->nch * p->nco > 2 ? 1 : 2);
  p->blocks_per_sm = by_smem < by_regs ? by_smem : by_regs;
  if (p->blocks_per_sm < 1) return -1;
  // Slabs: the fewest waves x (tiles of the longest slab + 1 for its
  // epilogue), with the dW partials within SCRATCH_CAP; the smallest such.
  const long long slots = (long long)sms * p->blocks_per_sm;
  const long long wsize = (long long)TAPS * C * Co;
  long long best = -1;
  p->slabs = 1;
  for (int s = 1; s <= p->tiles; ++s) {
    if (has_dw(kind) && s > 1 && s * wsize * 4 > SCRATCH_CAP) break;
    const long long blocks = (long long)s * TAPS * p->groups;
    const long long cost = ((blocks + slots - 1) / slots) * ((p->tiles + s - 1) / s + 1);
    if (best < 0 || cost < best) { best = cost; p->slabs = s; }
  }
  // The weight's fragments: float32 hi + lo, 2 x 9C x Co floats; bf16 pairs
  // along K steps of 16, 9C x 16 ceil(Co/16) bf16.
  p->wfrag_floats = !has_gs(kind) ? 0 : dtype == F32 ? 2 * wsize : (long long)TAPS * C * ((Co + 15) / 16) * 8;
  p->dw_floats = has_dw(kind) && p->slabs > 1 ? p->slabs * wsize : 0;
  p->coord_floats = has_dcoord(kind) && p->groups > 1 ? p->groups * M * 3 * TAPS : 0;
  return 0;
}

template <typename T, bool DX, bool DCOORD, bool DW, int NCH, int NCO>
int launch_main(const Plan& p, const BwdArgs& a, cudaStream_t s) {
  // Above 48 KB of dynamic shared memory a kernel must be allowed it (per
  // device; raised when a launch needs more than was allowed).
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || allowed[dev] < p.smem) {
    err = cudaFuncSetAttribute(dcn_v2_bwd_kernel<T, DX, DCOORD, DW, NCH, NCO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = p.smem;
  }
  const dim3 grid((unsigned)p.slabs, TAPS, (unsigned)p.groups);
  dcn_v2_bwd_kernel<T, DX, DCOORD, DW, NCH, NCO><<<grid, dim3(NT), p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool DX, bool DCOORD, bool DW>
int dispatch(const Plan& p, const BwdArgs& a, cudaStream_t s) {
  if (!DW) {
    if (p.nco == 1) return launch_main<T, DX, DCOORD, DW, 1, 1>(p, a, s);
    if (p.nco == 2) return launch_main<T, DX, DCOORD, DW, 1, 2>(p, a, s);
    return launch_main<T, DX, DCOORD, DW, 1, 4>(p, a, s);
  }
  if (p.nch == 2 && p.nco == 1) return launch_main<T, DX, DCOORD, DW, 2, 1>(p, a, s);
  if (p.nch == 1 && p.nco == 1) return launch_main<T, DX, DCOORD, DW, 1, 1>(p, a, s);
  if (p.nch == 1 && p.nco == 2) return launch_main<T, DX, DCOORD, DW, 1, 2>(p, a, s);
  if (p.nch == 1 && p.nco == 4) return launch_main<T, DX, DCOORD, DW, 1, 4>(p, a, s);
  return -1;
}

template <typename T>
int dispatch_kind(int kind, const Plan& p, const BwdArgs& a, cudaStream_t s) {
  switch (kind) {
    case FUSED: return dispatch<T, true, true, true>(p, a, s);
    case DXK: return dispatch<T, true, false, false>(p, a, s);
    case DCOORDK: return dispatch<T, false, true, false>(p, a, s);
    default: return dispatch<T, false, false, true>(p, a, s);
  }
}

int launch(int kind, int dtype, const void* x, const void* offset, const void* mask,
           const void* weight, const void* dout, void* dx, void* doffset, void* dmask, void* dw,
           void* scratch, long long scratch_floats, int B, int H, int W, int C, int Co,
           long long off_stride, long long mask_stride, int sms, void* stream) {
  Plan p;
  if (make_plan(kind, dtype, B, H, W, C, Co, sms, &p) != 0) return -1;
  const bool DX = kind == FUSED || kind == DXK;
  const bool DC = has_dcoord(kind), DWW = has_dw(kind);
  if (!offset || !mask || !dout) return -1;
  if ((DX || DC) && !weight) return -1;
  if ((DC || DWW) && !x) return -1;
  if ((DX && !dx) || (DC && (!doffset || !dmask)) || (DWW && !dw)) return -1;
  const long long need = p.wfrag_floats + p.dw_floats + p.coord_floats;
  if (scratch_floats < need || (need > 0 && !scratch)) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;

  float* sp = static_cast<float*>(scratch);
  float* dw_part = sp + p.wfrag_floats;
  float* off_part = dw_part + p.dw_floats;
  float* mask_part = off_part + (p.coord_floats ? p.groups * M * 2 * TAPS : 0);

  if (p.wfrag_floats) {
    const long long n = dtype == F32 ? p.wfrag_floats / 4 : p.wfrag_floats / 2;   // fragments
    const int blocks = (int)((n + 255) / 256 < 4LL * sms ? (n + 255) / 256 : 4LL * sms);
    if (dtype == F32)
      weight_fragments_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(weight),
                                                     reinterpret_cast<float4*>(sp), C, Co);
    else
      weight_fragments_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const bf16*>(weight),
                                                          reinterpret_cast<uint2*>(sp), C, Co);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  BwdArgs a;
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.wfrag = sp;
  a.dout = dout;
  a.dx = static_cast<float*>(dx);
  a.doffset = p.coord_floats ? off_part : static_cast<float*>(doffset);
  a.dmask = p.coord_floats ? mask_part : static_cast<float*>(dmask);
  a.dw = p.dw_floats ? dw_part : static_cast<float*>(dw);
  a.B = B; a.H = H; a.W = W; a.C = C; a.Co = Co;
  a.off_stride = off_stride;
  a.mask_stride = mask_stride;
  a.tiles = p.tiles;
  a.slabs = p.slabs;
  a.nch = p.nch;
  a.cop = 64 * p.nco;
  a.cop_log2 = p.nco == 1 ? 6 : (p.nco == 2 ? 7 : 8);
  const int err = dtype == F32 ? dispatch_kind<float>(kind, p, a, s) : dispatch_kind<bf16>(kind, p, a, s);
  if (err != 0) return err;

  SumJobs jobs;
  int njobs = 0;
  long long most = 0;
  if (p.dw_floats) {
    jobs.job[njobs++] = SumJob{dw_part, static_cast<float*>(dw), (long long)TAPS * C * Co, p.slabs};
  }
  if (p.coord_floats) {
    jobs.job[njobs++] = SumJob{off_part, static_cast<float*>(doffset), M * 2 * TAPS, p.groups};
    jobs.job[njobs++] = SumJob{mask_part, static_cast<float*>(dmask), M * TAPS, p.groups};
  }
  for (int i = 0; i < njobs; ++i) most = jobs.job[i].n > most ? jobs.job[i].n : most;
  if (njobs) {
    const long long want = (most + 255) / 256;
    const dim3 grid((unsigned)(want < 8LL * sms ? want : 8LL * sms), (unsigned)njobs);
    sum_partials_kernel<<<grid, 256, 0, s>>>(jobs);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// plan[0..10] = pixels per tile, tiles, slabs, grid x, y, z, channel chunks
// per block, 64-wide Co tiles of the dW accumulator, dynamic shared memory in
// bytes, blocks per SM assumed, scratch floats. kind: 0 fused, 1 dX, 2
// coordinates, 3 dW. dtype: 0 float32, 1 bf16 operands. `sms`: the card's
// multiprocessor count. Returns -1 for an argument the kernels do not take.
extern "C" int dcn_v2_bwd_plan(int kind, int dtype, int B, int H, int W, int C, int Co, int sms,
                               long long* plan) {
  Plan p;
  if (make_plan(kind, dtype, B, H, W, C, Co, sms, &p) != 0) return -1;
  const long long v[11] = {BM, p.tiles, p.slabs, p.slabs, TAPS, p.groups, p.nch, p.nco,
                           p.smem, p.blocks_per_sm, p.wfrag_floats + p.dw_floats + p.coord_floats};
  for (int i = 0; i < 11; ++i) plan[i] = v[i];
  return 0;
}

#define DCN_BWD_ARGS                                                              \
  const void *x, const void *offset, const void *mask, const void *weight,        \
      const void *dout, void *dx, void *doffset, void *dmask, void *dw,           \
      void *scratch, long long scratch_floats, int B, int H, int W, int C, int Co, \
      long long off_stride, long long mask_stride, int sms, void *stream
#define DCN_BWD_PASS                                                             \
  x, offset, mask, weight, dout, dx, doffset, dmask, dw, scratch, scratch_floats, \
      B, H, W, C, Co, off_stride, mask_stride, sms, stream

// All eight take the same arguments; a pointer the kernel does not use may be
// null (dx: x, doffset, dmask, dw; dcoord: dx, dw; dw: weight, dx, doffset,
// dmask). x, offset, mask, weight and dout are float32 (`*_launch`) or bf16
// (`*_bf16_launch`); dx, doffset, dmask and dw are float32 in both. Each
// launches, on `stream`, the weight's fragment copy (dX and coordinate
// terms), the main kernel and, where the plan has partials, their sum; it
// allocates nothing and does not synchronise. Returns cudaGetLastError()
// (0 = ok), or -1 for an argument it does not take.
extern "C" int dcn_v2_bwd_fused_launch(DCN_BWD_ARGS) { return launch(0, F32, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dx_launch(DCN_BWD_ARGS) { return launch(1, F32, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dcoord_launch(DCN_BWD_ARGS) { return launch(2, F32, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dw_launch(DCN_BWD_ARGS) { return launch(3, F32, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_fused_bf16_launch(DCN_BWD_ARGS) { return launch(0, BF16, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dx_bf16_launch(DCN_BWD_ARGS) { return launch(1, BF16, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dcoord_bf16_launch(DCN_BWD_ARGS) { return launch(2, BF16, DCN_BWD_PASS); }
extern "C" int dcn_v2_bwd_dw_bf16_launch(DCN_BWD_ARGS) { return launch(3, BF16, DCN_BWD_PASS); }
