// The tensor-core tile engine shared by K1 (vit_layer.cu), K3
// (vit_layer_train.cu) and K4 (attention.cu), for Hopper (sm_90a).
//
// Two kinds of product, both with f32 accumulation:
//  - bf16: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. Fragments
//    come from shared memory through ldmatrix (.trans for an operand stored
//    the other way round).
//  - f32 (3xTF32): mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Each
//    f32 operand x is split in registers into hi = tf32(x) and
//    lo = tf32(x - hi), both rounded to nearest with ties away (cvt.rna's
//    rounding, done by integer operations: tf32_rna), and
//    each product is lo.hi + hi.lo + hi.hi, the small terms first, into one
//    accumulator: about 2^-22 relative error a product instead of
//    single-pass TF32's 2^-11. ldmatrix (non-.trans) of 32-bit elements, as
//    pairs of b16, gives exactly the TF32 A fragment of a K-contiguous tile
//    and the B fragment of a tile stored (N, K); ldmatrix.trans is 16-bit
//    only, so an f32 operand stored (K, N) is read by scalar loads from a
//    tile padded so that a warp's reads fall on 32 distinct banks.
// Shared memory is fed by 16-byte cp.async.cg copies whose src-size operand
// zero-fills the ragged edges. Rows in shared memory are padded by 16 bytes,
// so the eight rows of one ldmatrix fall on eight different 16-byte bank
// groups.
//
// Engines:
//  - gemm (bf16): out[M, N] = op(A)[M, K] @ op(B)[K, N] with a fused
//    epilogue that sees the f32 accumulators in pairs of columns. Layouts NN
//    (A (M, K), B (K, N)), NT (B stored (N, K): dx = dY W^T) and TN (A
//    stored (K, M): dW = X^T dY). Block tiles 128x128 with 8 warps of 64x32,
//    or 128x64 with 8 warps of 32x32 where the larger tile's grid would fill
//    fewer than two waves; a 3-stage cp.async ring of 32-deep k slices. A TN
//    product may be split along K into partial products (blockIdx.z). Any
//    shape: an operand whose rows are a multiple of 8 elements long goes by
//    16-byte copies, each wholly inside or wholly outside the matrix; one
//    whose rows are not (an MLP width such as 100) goes element by element,
//    zero-filled past its edges. With an odd N the pair (n, n + 1) may end
//    past the matrix: the epilogue takes care of it.
//  - gemm_tf32 (f32, 3xTF32): the NN layout of the same block tiles and
//    epilogue contract, with a 4-stage ring of 16-deep k slices; A's
//    fragments by ldmatrix, B (K, N) by scalar loads (a pitch of BN + 8
//    floats puts the four k rows of a fragment 8 banks apart). Rows not a
//    multiple of 4 floats long go element by element.
//  - attention forward, per (image, head), bf16 or f32 operands: either
//    K1's p = exp(min(q.k, 80)) / sum (no max shift; also the row sums, for
//    K3's backward) or K4's p = exp(s - max s) / sum with q pre-scaled in
//    its type; p is rounded to the operands' type after the division, as the
//    TPU kernels round it, then p @ v. q, k and v are read in place from
//    strided views (the (B*N, 3C) rows of K1 and K3's qkv, or K4's (B, N, 3,
//    h, d) projection); the output is (B*N, C) rows. A block takes 16 queries
//    a warp. Which instance takes which shapes (attention_launch):
//     - N <= 192 (the 256x192 crops), heads up to 64 wide: one pass. K and V
//       sit whole in shared memory (v's copy lands while the scores are
//       computed) and the key row stays in registers, so each score is
//       computed once (bf16: 4 warps, 4 blocks an SM; f32: 12 warps, the 192
//       queries of an image's head, one block an SM by registers).
//     - f32, N <= 192, heads 65 to 96 wide (ViT-H's 80): the same one pass,
//       12 warps and 192 queries a block, K and V read once for the head
//       (193,536 bytes of shared memory at 80, 230,400 at 96); the output is
//       computed 48 columns at a time from the same p in registers, so the
//       accumulators take 24 registers beside the key row's 96, fewer than
//       the instance above's 32, and no score is recomputed.
//     - otherwise two passes over key chunks (K4: a running maximum in the
//       first), K and V whole in shared memory where they fit and streamed a
//       chunk at a time where they do not, and the output computed 64
//       columns at a time, its scores recomputed for each; heads up to 896
//       wide. Its f32 form runs 2 warps a block, so that a streamed block
//       fits 896-wide heads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T cast(float v);
template <> __device__ __forceinline__ float cast<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cast<bf16>(float v) { return __float2bfloat16(v); }

// 16 bytes from global to shared memory; zeros when !in (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}

// the 16 bytes dst[0, 16 / sizeof(T)) = src[0, run), zeros from run on; a
// plain load and store each
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int run) {
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) dst[e] = e < run ? src[e] : cast<T>(0.f);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; of 32-bit elements (f32), four 8x4 matrices whose
// element (row g, col t) lands in lane 4 g + t
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) . b (8x8, col), TF32 operands. Fragments (g = lane / 4,
// t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, n g), b1 (k t + 4, n g); d as m16n8k16's.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's TF32 rounding (to nearest, ties away), in an f32's bits: half a TF32
// ulp added to the magnitude's bits, then the low 13 bits cleared. The same
// bits as cvt.rna.tf32.f32 for every x but a NaN with only low payload bits
// (which becomes an infinity here and makes its products NaN all the same),
// in two integer operations, where cvt compiles on sm_90a to compares and
// selects around the rounding; every fragment of every product is split.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo + O(2^-22 |x|), both TF32
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Split s = split_tf32(__uint_as_float(x[i]));
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// d += a . b in 3xTF32: lo.hi and hi.lo first, hi.hi last
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], Split b0,
                                     Split b1) {
  mma1688(d, al, b0.hi, b1.hi);
  mma1688(d, ah, b0.lo, b1.lo);
  mma1688(d, ah, b0.hi, b1.hi);
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// s / l from inv = 1 / l, both correctly rounded: q = s * inv is within an
// ulp of the quotient, and one correction with the exact residual s - q l
// (an fma) rounds it correctly (Markstein). The same value as s / l wherever
// the quotient is a normal float, for three operations instead of the
// division's subroutine, once per score.
__device__ __forceinline__ float div_by(float s, float l, float inv) {
  const float q = s * inv;
  return fmaf(fmaf(-q, l, s), inv, q);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// GEMM
// ---------------------------------------------------------------------------
enum Layout { NN = 0, NT = 1, TN = 2 };

constexpr int kSMs = 132;
constexpr size_t kSmemMax = 232448;  // bytes a block may use (opt-in)

template <int BM_, int BN_, int WM_, int WN_, int LAYOUT_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, LAYOUT = LAYOUT_;
  static constexpr int BK = 32, STAGES = 3, THREADS = WM * WN * 32;
  static constexpr int TILES_M = BM / WM / 16, TILES_N = BN / WN / 8;  // mma tiles of a warp
  static constexpr bool A_T = LAYOUT == TN;                  // A stored (K, M)
  static constexpr bool B_T = LAYOUT == NT;                  // B stored (N, K)
  static constexpr int A_ROWS = A_T ? BK : BM, A_COLS = A_T ? BM : BK;
  static constexpr int B_ROWS = B_T ? BN : BK, B_COLS = B_T ? BK : BN;
  static constexpr int A_P = A_COLS + 8, B_P = B_COLS + 8;  // padded pitches (elements)
  static constexpr int STAGE = A_ROWS * A_P + B_ROWS * B_P;  // elements per stage
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(TILES_N % 2 == 0, "B fragments are loaded two n-tiles at a time");
};

template <class G, class Epi>
__global__ void __launch_bounds__(G::THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, Epi epi, int M, int N, int K,
            int k_chunk) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sm = reinterpret_cast<bf16*>(tc_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / G::WN) * (G::BM / G::WM), wn0 = (warp % G::WN) * (G::BN / G::WN);
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int nk = (kend - kbeg + G::BK - 1) / G::BK;

  // rows whose pitch is a multiple of 8 go by 16-byte copies; others element
  // by element (a 16-byte copy would be misaligned)
  const bool a_vec = (G::A_T ? M : K) % 8 == 0, b_vec = (G::B_T ? K : N) % 8 == 0;
  auto load = [&](int stage, int k0) {
    bf16* as = sm + stage * G::STAGE;
    bf16* bs = as + G::A_ROWS * G::A_P;
    constexpr int AC = G::A_COLS / 8, BC = G::B_COLS / 8;
    static_assert((G::A_ROWS * AC) % G::THREADS == 0 && (G::B_ROWS * BC) % G::THREADS == 0, "whole copies");
#pragma unroll
    for (int it = 0; it < G::A_ROWS * AC / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      const int r = i / AC, c = (i % AC) * 8;
      const int gm = G::A_T ? m0 + c : m0 + r;
      const int gk = G::A_T ? k0 + r : k0 + c;
      if (a_vec) {
        const bool in = gm < M && gk < kend;
        const bf16* src = !in ? A : G::A_T ? A + (size_t)gk * M + gm : A + (size_t)gm * K + gk;
        cp_async16(as + r * G::A_P + c, src, in);
      } else {
        // the row runs along m (A_T) or k: elements past M or kend are zeros
        const int run = G::A_T ? (gk < kend ? M - gm : 0) : (gm < M ? kend - gk : 0);
        const bf16* src = G::A_T ? A + (size_t)gk * M + gm : A + (size_t)gm * K + gk;
        copy_chunk(as + r * G::A_P + c, src, run);
      }
    }
#pragma unroll
    for (int it = 0; it < G::B_ROWS * BC / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      const int r = i / BC, c = (i % BC) * 8;
      const int gn = G::B_T ? n0 + r : n0 + c;
      const int gk = G::B_T ? k0 + c : k0 + r;
      if (b_vec) {
        const bool in = gn < N && gk < kend;
        const bf16* src = !in ? B : G::B_T ? B + (size_t)gn * K + gk : B + (size_t)gk * N + gn;
        cp_async16(bs + r * G::B_P + c, src, in);
      } else {
        const int run = G::B_T ? (gn < N ? kend - gk : 0) : (gk < kend ? N - gn : 0);
        const bf16* src = G::B_T ? B + (size_t)gn * K + gk : B + (size_t)gk * N + gn;
        copy_chunk(bs + r * G::B_P + c, src, run);
      }
    }
  };

  float acc[G::TILES_M][G::TILES_N][4];
#pragma unroll
  for (int i = 0; i < G::TILES_M; ++i)
#pragma unroll
    for (int j = 0; j < G::TILES_N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load(s, kbeg + s * G::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int kn = kt + G::STAGES - 1;
    if (kn < nk) load(kn % G::STAGES, kbeg + kn * G::BK);
    cp_async_commit();

    const bf16* as = sm + (kt % G::STAGES) * G::STAGE;
    const bf16* bs = as + G::A_ROWS * G::A_P;
#pragma unroll
    for (int ks = 0; ks < G::BK / 16; ++ks) {
      uint32_t af[G::TILES_M][4], bfr[G::TILES_N / 2][4];
#pragma unroll
      for (int mt = 0; mt < G::TILES_M; ++mt) {
        if (G::A_T)
          ldsm_x4_t(af[mt], as + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * G::A_P + wm0 + mt * 16 +
                                ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[mt], as + (wm0 + mt * 16 + (lane & 15)) * G::A_P + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < G::TILES_N / 2; ++np) {
        if (G::B_T)
          ldsm_x4(bfr[np], bs + (wn0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * G::B_P + ks * 16 +
                               ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(bfr[np], bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * G::B_P + wn0 +
                                 np * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < G::TILES_M; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::TILES_N; ++nt)
          mma16816(acc[mt][nt], af[mt], bfr[nt / 2][(nt & 1) * 2], bfr[nt / 2][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < G::TILES_M; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::TILES_N; ++nt) {
      const int m = m0 + wm0 + mt * 16 + g;
      const int n = n0 + wn0 + nt * 8 + 2 * t;
      if (n < N) {
        if (m < M) epi(m, n, acc[mt][nt][0], acc[mt][nt][1]);
        if (m + 8 < M) epi(m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
}

template <int L> using GemmBig = GemmCfg<128, 128, 2, 4, L>;
template <int L> using GemmSmall = GemmCfg<128, 64, 4, 2, L>;

template <class G, class Epi>
cudaError_t gemm_launch(const bf16* A, const bf16* B, const Epi& epi, int M, int N, int K, int k_chunk,
                        int splits, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<G, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM, splits);
  gemm_kernel<G, Epi><<<grid, G::THREADS, G::SMEM, s>>>(A, B, epi, M, N, K, k_chunk);
  return cudaGetLastError();
}

// 128x128 tiles where their grid fills two waves of two blocks an SM
inline bool big_tiles(int M, int N) {
  return (long)((M + 127) / 128) * ((N + 127) / 128) >= 2 * 2 * kSMs;
}

// One product over the whole K: 128x128 tiles where their grid fills two
// waves of two blocks an SM, else 128x64.
template <int L, class Epi>
cudaError_t gemm(const bf16* A, const bf16* B, const Epi& epi, int M, int N, int K, cudaStream_t s) {
  if (big_tiles(M, N)) return gemm_launch<GemmBig<L>>(A, B, epi, M, N, K, K, 1, s);
  return gemm_launch<GemmSmall<L>>(A, B, epi, M, N, K, K, 1, s);
}

// ---------------------------------------------------------------------------
// f32 GEMM in 3xTF32: out[M, N] = A[M, K] @ B[K, N], both row-major
// ---------------------------------------------------------------------------
template <int BM_, int BN_, int WM_, int WN_>
struct Tf32Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  // 16-deep k slices in a 4-stage ring, the shared memory of bf16's 32-deep
  // slices in 3 stages: faster at the ViT-B shapes (more slices in flight)
  static constexpr int BK = 16, STAGES = 4, THREADS = WM * WN * 32;
  static constexpr int TILES_M = BM / WM / 16, TILES_N = BN / WN / 8;  // mma tiles of a warp
  // A: ldmatrix rows 80 bytes apart (eight distinct 16-byte groups); B: the
  // rows k and k + 1 of a fragment's scalar reads 8 banks apart
  static constexpr int A_P = BK + 4, B_P = BN + 8;  // floats
  static constexpr int STAGE = BM * A_P + BK * B_P;  // floats per stage
  static constexpr int SMEM = STAGES * STAGE * 4;
};

template <class G, class Epi>
__global__ void __launch_bounds__(G::THREADS, 2)
gemm_tf32_kernel(const float* __restrict__ A, const float* __restrict__ B, Epi epi, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sm = reinterpret_cast<float*>(tc_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / G::WN) * (G::BM / G::WM), wn0 = (warp % G::WN) * (G::BN / G::WN);
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  const int nk = (K + G::BK - 1) / G::BK;

  // rows whose length is a multiple of 4 floats go by 16-byte copies, each
  // wholly inside or wholly outside the matrix; others element by element
  const bool a_vec = K % 4 == 0, b_vec = N % 4 == 0;
  auto load = [&](int stage, int k0) {
    float* as = sm + stage * G::STAGE;
    float* bs = as + G::BM * G::A_P;
    constexpr int AC = G::BK / 4, BC = G::BN / 4;
    static_assert((G::BM * AC) % G::THREADS == 0 && (G::BK * BC) % G::THREADS == 0, "whole copies");
#pragma unroll
    for (int it = 0; it < G::BM * AC / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      const int r = i / AC, c = (i % AC) * 4, gm = m0 + r, gk = k0 + c;
      if (a_vec) {
        const bool in = gm < M && gk < K;
        cp_async16(as + r * G::A_P + c, in ? A + (size_t)gm * K + gk : A, in);
      } else {
        copy_chunk(as + r * G::A_P + c, A + (size_t)gm * K + gk, gm < M ? K - gk : 0);
      }
    }
#pragma unroll
    for (int it = 0; it < G::BK * BC / G::THREADS; ++it) {
      const int i = tid + it * G::THREADS;
      const int r = i / BC, c = (i % BC) * 4, gk = k0 + r, gn = n0 + c;
      if (b_vec) {
        const bool in = gk < K && gn < N;
        cp_async16(bs + r * G::B_P + c, in ? B + (size_t)gk * N + gn : B, in);
      } else {
        copy_chunk(bs + r * G::B_P + c, B + (size_t)gk * N + gn, gk < K ? N - gn : 0);
      }
    }
  };

  float acc[G::TILES_M][G::TILES_N][4];
#pragma unroll
  for (int i = 0; i < G::TILES_M; ++i)
#pragma unroll
    for (int j = 0; j < G::TILES_N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load(s, s * G::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int kn = kt + G::STAGES - 1;
    if (kn < nk) load(kn % G::STAGES, kn * G::BK);
    cp_async_commit();

    const float* as = sm + (kt % G::STAGES) * G::STAGE;
    const float* bs = as + G::BM * G::A_P;
#pragma unroll
    for (int ks = 0; ks < G::BK / 8; ++ks) {
      Split b0[G::TILES_N], b1[G::TILES_N];
#pragma unroll
      for (int nt = 0; nt < G::TILES_N; ++nt) {
        const float* bp = bs + (ks * 8 + t) * G::B_P + wn0 + nt * 8 + g;
        b0[nt] = split_tf32(bp[0]);
        b1[nt] = split_tf32(bp[4 * G::B_P]);
      }
#pragma unroll
      for (int mt = 0; mt < G::TILES_M; ++mt) {
        uint32_t af[4], ah[4], al[4];
        ldsm_x4(af, as + (wm0 + mt * 16 + (lane & 15)) * G::A_P + ks * 8 + (lane >> 4) * 4);
        split_tf32(af, ah, al);
#pragma unroll
        for (int nt = 0; nt < G::TILES_N; ++nt) mma3(acc[mt][nt], ah, al, b0[nt], b1[nt]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < G::TILES_M; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::TILES_N; ++nt) {
      const int m = m0 + wm0 + mt * 16 + g;
      const int n = n0 + wn0 + nt * 8 + 2 * t;
      if (n < N) {
        if (m < M) epi(m, n, acc[mt][nt][0], acc[mt][nt][1]);
        if (m + 8 < M) epi(m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
}

using Tf32Big = Tf32Cfg<128, 128, 2, 4>;
using Tf32Small = Tf32Cfg<128, 64, 4, 2>;

template <class G, class Epi>
cudaError_t gemm_tf32_launch(const float* A, const float* B, const Epi& epi, int M, int N, int K, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(gemm_tf32_kernel<G, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  gemm_tf32_kernel<G, Epi><<<grid, G::THREADS, G::SMEM, s>>>(A, B, epi, M, N, K);
  return cudaGetLastError();
}

// The tile choice of gemm: 128x128 where its grid fills two waves, else 128x64.
template <class Epi>
cudaError_t gemm_tf32(const float* A, const float* B, const Epi& epi, int M, int N, int K, cudaStream_t s) {
  if (big_tiles(M, N)) return gemm_tf32_launch<Tf32Big>(A, B, epi, M, N, K, s);
  return gemm_tf32_launch<Tf32Small>(A, B, epi, M, N, K, s);
}

// ---------------------------------------------------------------------------
// Attention building blocks: a warp owns 16 rows; rows of q, k, v, dO sit in
// shared memory at pitch P = DP + 16 bytes, DP = D rounded up to 16 with
// zero columns. The rows a block sweeps (keys; queries on the key side of
// the backward) sit whole in shared memory where they fit ("resident"), else
// they stream through it a chunk at a time. An output wider than a kernel's
// DMAX columns is computed DMAX columns at a time: from the same p in
// registers in the one-pass forward, its scores recomputed for each chunk
// elsewhere.
// ---------------------------------------------------------------------------
constexpr int ATT_ROWS = 64, ATT_WARPS = 4, ATT_THREADS = ATT_WARPS * 32;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }
// f32: P = DP + 4 is 4 mod 8, so the scalar reads of mma_ab (rows 2t, 2t + 1)
// fall on 32 distinct banks
template <typename T = bf16>
__host__ __device__ __forceinline__ int att_pitch(int D) { return round16(D) + 16 / (int)sizeof(T); }

// dst[r * P + c] = src[(r0 + r) * rs + c] for r < rows, c < DP; zeros past N
// rows and past D columns. vec: src and rs are 16-byte aligned, so the
// 16-byte chunks wholly inside a row go by cp.async; the rest element by
// element.
template <typename T, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int P, const T* src, size_t rs, int r0, int rows, int N, int D,
                                          bool vec, int tid) {
  constexpr int CH = 16 / sizeof(T);
  const int cpr = round16(D) / CH;
  for (int i = tid; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * CH, n = r0 + r;
    const T* s = src + (size_t)n * rs + c;
    if (vec && c + CH <= D)
      cp_async16(dst + r * P + c, n < N ? s : src, n < N);
    else
      copy_chunk(dst + r * P + c, s, n < N ? D - c : 0);
  }
}

// load_rows of a bf16 (rows, 3C) qkv's head columns [col0, col0 + D), D a multiple of 8
__device__ __forceinline__ void load_head_rows(bf16* dst, int P, const bf16* src, size_t rs, int col0, int r0,
                                               int rows, int N, int D, int tid) {
  load_rows<bf16, ATT_THREADS>(dst, P, src + col0, rs, r0, rows, N, D, true, tid);
}

// acc[j] (2 NJ tiles of 8 columns) += A . B^T. A: the warp's 16 rows at a;
// B: rows b[0, 16 NJ); both DP wide. 16-row groups of B at or past `rows`
// are skipped (their accumulators stay as they are). KD: the widest DP, for
// which the loop over DP is unrolled; 0: any DP, a plain loop.
template <int NJ, int KD>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NJ][4], const bf16* a, const bf16* b, int P, int DP,
                                        int rows, int lane) {
  auto step = [&](int kd) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * P + kd + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (jj * 16 < rows) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * P + kd + ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * jj], af, bfr[0], bfr[1]);
        mma16816(acc[2 * jj + 1], af, bfr[2], bfr[3]);
      }
    }
  };
  if constexpr (KD > 0) {
#pragma unroll
    for (int kd = 0; kd < KD; kd += 16) {
      if (kd >= DP) break;
      step(kd);
    }
  } else {
    for (int kd = 0; kd < DP; kd += 16) step(kd);
  }
}

// The same in 3xTF32, 8 columns of the depth a step: the A fragment (rows
// 0-15, depth kd..kd+7) and a B fragment pair (rows 0-15 of b) each from one
// ldmatrix.
template <int NJ, int KD>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NJ][4], const float* a, const float* b, int P, int DP,
                                        int rows, int lane) {
  auto step = [&](int kd) {
    uint32_t af[4], ah[4], al[4];
    ldsm_x4(af, a + (lane & 15) * P + kd + (lane >> 4) * 4);
    split_tf32(af, ah, al);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (jj * 16 < rows) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * P + kd + ((lane >> 3) & 1) * 4);
        const Split b0 = split_tf32(__uint_as_float(bfr[0])), b1 = split_tf32(__uint_as_float(bfr[1]));
        const Split b2 = split_tf32(__uint_as_float(bfr[2])), b3 = split_tf32(__uint_as_float(bfr[3]));
        mma3(acc[2 * jj], ah, al, b0, b1);
        mma3(acc[2 * jj + 1], ah, al, b2, b3);
      }
    }
  };
  if constexpr (KD > 0) {
#pragma unroll
    for (int kd = 0; kd < KD; kd += 8) {
      if (kd >= DP) break;
      step(kd);
    }
  } else {
    for (int kd = 0; kd < DP; kd += 8) step(kd);
  }
}

// acc[dt] (DMAX / 8 tiles of 8 columns) += round_bf16(p) . B. p: 16 x 16 NJ
// in accumulator layout; B: rows b[0, 16 NJ), its first DP columns (at most
// DMAX). 16-row groups at or past `rows` are skipped.
template <int NJ, int DMAX>
__device__ __forceinline__ void mma_ab(float (&acc)[DMAX / 8][4], const float (&p)[2 * NJ][4], const bf16* b,
                                       int P, int DP, int rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < NJ; ++kk) {
    if (kk * 16 >= rows) break;
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      if (dp * 16 >= DP) break;
      uint32_t bfr[4];
      ldsm_x4_t(bfr, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], af, bfr[0], bfr[1]);
      mma16816(acc[2 * dp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// The same in 3xTF32 (p is not rounded: f32 is its type). A sum over k does
// not depend on the order of k, so a tile of 8 keys enters the product with
// its k slots permuted: slot t holds key 2t and slot t + 4 key 2t + 1. The
// accumulator pair (2t, 2t + 1) of p is then the A fragment as it stands,
// and B = v's rows 2t and 2t + 1, read by scalar loads (P = 4 mod 8 puts the
// two rows of a warp's reads on distinct banks).
template <int NJ, int DMAX>
__device__ __forceinline__ void mma_ab(float (&acc)[DMAX / 8][4], const float (&p)[2 * NJ][4], const float* b,
                                       int P, int DP, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * NJ; ++j) {
    if (j * 8 >= rows) break;
    uint32_t ah[4], al[4];
    const uint32_t af[4] = {__float_as_uint(p[j][0]), __float_as_uint(p[j][2]), __float_as_uint(p[j][1]),
                            __float_as_uint(p[j][3])};
    split_tf32(af, ah, al);
    const float* br = b + (j * 8 + 2 * t) * P + g;
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt) {
      if (dt * 8 >= DP) break;
      mma3(acc[dt], ah, al, split_tf32(br[dt * 8]), split_tf32(br[P + dt * 8]));
    }
  }
}

template <int DT>
__device__ __forceinline__ void zero(float (&acc)[DT][4]) {
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// s <- exp(min(s, 80)) where the column (key0 + its index) is below N, else 0
template <int NT>
__device__ __forceinline__ void exp_clamp_mask(float (&s)[NT][4], int key0, int N, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (key0 + j * 8 + 8 <= N) {  // the whole tile is inside: no mask (warp-uniform)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(fminf(s[j][e], 80.f));
    } else {
      const int k = key0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = k + (e & 1) < N ? expf(fminf(s[j][e], 80.f)) : 0.f;
    }
  }
}

// m0, m1 <- the maxima of rows g, g + 8 over columns (key0 + index) below N
// and m0, m1 themselves
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], int key0, int N, int lane, float& m0, float& m1) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k = key0 + j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + (e & 1) < N) {
        if (e < 2)
          m0 = fmaxf(m0, s[j][e]);
        else
          m1 = fmaxf(m1, s[j][e]);
      }
    }
  }
}

// s <- exp(s - m) of its row's m where the column is below N, else 0
template <int NT>
__device__ __forceinline__ void exp_shift_mask(float (&s)[NT][4], int key0, int N, int lane, float m0, float m1) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k = key0 + j * 8 + 2 * t;
    const bool whole = key0 + j * 8 + 8 <= N;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = whole || k + (e & 1) < N ? expf(s[j][e] - (e < 2 ? m0 : m1)) : 0.f;
  }
}

// l (a sum of exp(s - m)) re-based from the maximum m to mn >= m
__device__ __forceinline__ float rebase(float l, float m, float mn) { return m == mn ? l : l * expf(m - mn); }

__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// rows r, r + 8 of a warp's accumulators (columns [0, D)) to row-major dst;
// pairs of columns where D is even, else one at a time
template <int DT, typename Tout>
__device__ __forceinline__ void store_rows(Tout* dst, size_t pitch, const float (&acc)[DT][4], int r, int N,
                                           int D, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (d >= D) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= N) continue;
      Tout* o = dst + (size_t)row * pitch + d;
      if (D % 2 == 0) {
        store2(o, acc[dt][2 * h], acc[dt][2 * h + 1]);
      } else {
        store1(o, acc[dt][2 * h]);
        if (d + 1 < D) store1(o + 1, acc[dt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention forward
// ---------------------------------------------------------------------------
// q, k and v of an (image b, token n, head h) at base + b sb + n sn + h sh, d
// contiguous; out (B*N, H*D) row-major; lsum (B*N, H) or null
template <typename T>
struct Heads {
  const T* q;
  const T* k;
  const T* v;
  long long sb[3], sn[3], sh[3];  // of q, k, v
  T* out;
  float* lsum;
  float scale;  // SHIFT: q' = round_T(q * round_T(scale)), in shared memory
  int N, H, D;
  int vec;  // every base and stride 16-byte aligned
};

// shared memory of a block of `rows` queries whose keys and values take
// `kv_rows` rows each
template <typename T>
__host__ __device__ __forceinline__ size_t attention_fwd_smem(int rows, int kv_rows, int D) {
  return (size_t)(rows + 2 * kv_rows) * att_pitch<T>(D) * sizeof(T);
}

// WARPS x 16 queries a block, KCH keys a chunk, DMAX output columns at a
// time; SHIFT: K4's math (q scaled in T, a max-shifted softmax), else K1's
// exp(min(s, 80)) on q as given. ONE (the
// caller sees to N <= KCH and D <= OCH x DMAX): one pass, the scores stay in
// registers, the loop over the depth unrolled, and p @ v is taken for each
// of the OCH chunks of DMAX output columns from the same p. Otherwise two
// passes over key chunks: the row sums (and, SHIFT, the running maxima),
// then p @ v for each chunk of DMAX output columns.
// MINB blocks an SM bound the registers: the bf16 kernel is bound by
// latency, not by its few operations, and four blocks an SM hide it better
// than the registers the compiler would otherwise take.
template <typename T, int WARPS, int KCH, int DMAX, bool ONE, bool SHIFT, int MINB, int OCH = 1>
__global__ void __launch_bounds__(WARPS * 32, MINB)
attention_fwd_kernel(const Heads<T> a, int resident) {
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int N = a.N, D = a.D, DP = round16(D), P = att_pitch<T>(D), NP = round16(N);
  T* qs = reinterpret_cast<T*>(tc_smem);
  T* ks = qs + ROWS * P;
  T* vs = ks + (resident ? NP : KCH) * P;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = a.q + b * a.sb[0] + h * a.sh[0];
  const T* kb = a.k + b * a.sb[1] + h * a.sh[1];
  const T* vb = a.v + b * a.sb[2] + h * a.sh[2];
  const bool vec = a.vec;

  // q and, resident, k first; v lands while the scores are computed
  load_rows<T, THREADS>(qs, P, qb, a.sn[0], q0, ROWS, N, D, vec, tid);
  if (resident) {
    load_rows<T, THREADS>(ks, P, kb, a.sn[1], 0, NP, N, D, vec, tid);
    cp_async_commit();
    load_rows<T, THREADS>(vs, P, vb, a.sn[2], 0, NP, N, D, vec, tid);
  }
  cp_async_commit();
  if (resident)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  if constexpr (SHIFT) {  // q' = round_T(q * round_T(scale)) in place; zeros stay zeros
    const float sc = as_float(cast<T>(a.scale));
    for (int i = tid; i < ROWS * DP; i += THREADS) {
      T* e = qs + (i / DP) * P + i % DP;
      *e = cast<T>(as_float(*e) * sc);
    }
    __syncthreads();
  }

  // where keys [c0, c0 + KCH) sit in ks and vs: resident, or copied in now
  auto chunk = [&](int c0, bool with_v) {
    if (resident) return c0 * P;
    __syncthreads();  // every warp is done with the previous chunk
    load_rows<T, THREADS>(ks, P, kb, a.sn[1], c0, KCH, N, D, vec, tid);
    if (with_v) load_rows<T, THREADS>(vs, P, vb, a.sn[2], c0, KCH, N, D, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    return 0;
  };

  const T* qw = qs + warp * 16 * P;
  float s[KCH / 8][4];
  float o[DMAX / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // SHIFT: the maxima of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // their sums
  float inv0 = 1.f, inv1 = 1.f;          // their reciprocals

  auto scores = [&](int ko, int c0) {
    zero(s);
    mma_abt<KCH / 16, ONE ? OCH * DMAX : 0>(s, qw, ks + ko, P, DP, N - c0, lane);
  };
  auto exps = [&](int c0) {
    if constexpr (SHIFT)
      exp_shift_mask(s, c0, N, lane, m0, m1);
    else
      exp_clamp_mask(s, c0, N, lane);
  };
  auto rowsum = [&]() {
#pragma unroll
    for (int j = 0; j < KCH / 8; ++j) {
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  };
  // the rows' maxima and sums over the quad
  auto reduce = [&]() {
    if constexpr (SHIFT) {
      const float n0 = quad_max(m0), n1 = quad_max(m1);
      l0 = rebase(l0, m0, n0);
      l1 = rebase(l1, m1, n1);
      m0 = n0;
      m1 = n1;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
  };
  // p = s / l in place, rounded to T (in mma_ab) after the division
  auto divide = [&]() {
#pragma unroll
    for (int j = 0; j < KCH / 8; ++j) {
      s[j][0] = div_by(s[j][0], l0, inv0);
      s[j][1] = div_by(s[j][1], l0, inv0);
      s[j][2] = div_by(s[j][2], l1, inv1);
      s[j][3] = div_by(s[j][3], l1, inv1);
    }
  };
  // o += p @ v[:, dc0:]
  auto pv = [&](int ko, int c0, int dc0) {
    mma_ab<KCH / 16, DMAX>(o, s, vs + ko + dc0, P, DP - dc0, N - c0, lane);
  };

  const int r = q0 + warp * 16 + (lane >> 2);
  const size_t pitch = (size_t)a.H * D;
  T* orow = a.out + (size_t)b * N * pitch + h * D;
  if constexpr (ONE) {  // resident: the scores stay in registers
    scores(0, 0);
    if constexpr (SHIFT) {
      row_max(s, 0, N, lane, m0, m1);
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    }
    exps(0);
    rowsum();
    reduce();
    cp_async_wait<0>();
    __syncthreads();
    divide();
#pragma unroll
    for (int c = 0; c < OCH; ++c) {  // DMAX output columns at a time, each from the same p
      const int dc0 = c * DMAX;
      if (c > 0 && dc0 >= DP) break;
      zero(o);
      pv(0, 0, dc0);
      store_rows(orow + dc0, pitch, o, r, N, D - dc0, lane);
    }
  } else {
    for (int c0 = 0; c0 < N; c0 += KCH) {
      scores(chunk(c0, false), c0);
      if constexpr (SHIFT) {  // a running maximum: the sum so far re-based to it
        float n0 = m0, n1 = m1;
        row_max(s, c0, N, lane, n0, n1);
        l0 = rebase(l0, m0, n0);
        l1 = rebase(l1, m1, n1);
        m0 = n0;
        m1 = n1;
      }
      exps(c0);
      rowsum();
    }
    reduce();
    cp_async_wait<0>();
    __syncthreads();
    for (int dc0 = 0; dc0 < D; dc0 += DMAX) {
      zero(o);
      for (int c0 = 0; c0 < N; c0 += KCH) {
        const int ko = chunk(c0, true);
        scores(ko, c0);
        exps(c0);
        divide();
        pv(ko, c0, dc0);
      }
      store_rows(orow + dc0, pitch, o, r, N, D - dc0, lane);
    }
  }
  if (a.lsum != nullptr && (lane & 3) == 0) {
    if (r < N) a.lsum[((size_t)b * N + r) * a.H + h] = l0;
    if (r + 8 < N) a.lsum[((size_t)b * N + r + 8) * a.H + h] = l1;
  }
}

// The instances of T. One pass (N <= 192, heads up to 64 wide): bf16 4 warps
// and 4 blocks an SM; f32 the 192 queries of a head in 12 warps, its key row
// (96 registers) and output (32) within the 168 registers of one block an SM.
// f32's wide one pass (N <= 192, heads up to WIDE_D = 96 wide): the same 12
// warps, the output in chunks of WIDE_DMAX = 48 columns (24 registers).
// Two passes: bf16 4 warps and 32-key chunks; f32 2 warps and 16-key chunks,
// so that heads up to 896 wide fit one block's shared memory when streamed.
template <typename T> struct AttCfg;
template <> struct AttCfg<bf16> {
  static constexpr int ONE_WARPS = 4, ONE_MINB = 4, WARPS = 4, KCH = 32, MINB = 4;
};
template <> struct AttCfg<float> {
  static constexpr int ONE_WARPS = 12, ONE_MINB = 1, WARPS = 2, KCH = 16, MINB = 4, WIDE_D = 96, WIDE_DMAX = 48;
};

// What attention_heads launches for N keys of heads D wide: the instance,
// its threads, grid and shared memory, and whether K and V sit whole in
// shared memory
template <typename T>
struct AttLaunch {
  void (*kernel)(const Heads<T>, int);
  int threads;
  dim3 grid;
  size_t smem;
  int resident;
};

template <typename T, bool SHIFT>
AttLaunch<T> attention_launch(int N, int D, int H, int B) {
  using Cfg = AttCfg<T>;
  const int NP = round16(N);
  if (N <= 192 && round16(D) <= 64) {
    constexpr int W = Cfg::ONE_WARPS;
    return {attention_fwd_kernel<T, W, 192, 64, true, SHIFT, Cfg::ONE_MINB>, 32 * W,
            dim3((N + 16 * W - 1) / (16 * W), H, B), attention_fwd_smem<T>(16 * W, NP, D), 1};
  }
  if constexpr (sizeof(T) == 4) {
    if (N <= 192 && round16(D) <= Cfg::WIDE_D) {
      constexpr int W = Cfg::ONE_WARPS, OCH = Cfg::WIDE_D / Cfg::WIDE_DMAX;
      return {attention_fwd_kernel<T, W, 192, Cfg::WIDE_DMAX, true, SHIFT, Cfg::ONE_MINB, OCH>, 32 * W,
              dim3((N + 16 * W - 1) / (16 * W), H, B), attention_fwd_smem<T>(16 * W, NP, D), 1};
    }
  }
  constexpr int W = Cfg::WARPS;
  const int resident = attention_fwd_smem<T>(16 * W, NP, D) <= kSmemMax;
  return {attention_fwd_kernel<T, W, Cfg::KCH, 64, false, SHIFT, Cfg::MINB>, 32 * W,
          dim3((N + 16 * W - 1) / (16 * W), H, B), attention_fwd_smem<T>(16 * W, resident ? NP : Cfg::KCH, D),
          resident};
}

template <typename T, bool SHIFT>
cudaError_t attention_heads(const Heads<T>& a, int B, cudaStream_t s) {
  const AttLaunch<T> l = attention_launch<T, SHIFT>(a.N, a.D, a.H, B);
  cudaError_t e = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return e;
  const auto kernel = l.kernel;
  kernel<<<l.grid, l.threads, l.smem, s>>>(a, l.resident);
  return cudaGetLastError();
}

// What the instance attention_heads launches for (N, D) holds on an SM:
// out = {registers a thread, local memory a thread (spills), dynamic shared
// memory a block, threads a block, blocks resident an SM}
template <typename T, bool SHIFT>
cudaError_t attention_occupancy(int N, int D, int* out) {
  const AttLaunch<T> l = attention_launch<T, SHIFT>(N, D, 1, 1);
  cudaError_t e = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, l.kernel);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)l.smem;
  out[3] = l.threads;
  out[4] = blocks;
  return cudaSuccess;
}

// K1 and K3's attention: a (B*N, 3C) qkv, C a multiple of 8; out (B*N, C),
// lsum (B*N, H) or null
template <typename T>
cudaError_t attention_fwd(const T* qkv, T* out, float* lsum, int B, int N, int C, int H, cudaStream_t s) {
  const int D = C / H;
  Heads<T> a{};
  a.q = qkv;
  a.k = qkv + C;
  a.v = qkv + 2 * C;
  for (int i = 0; i < 3; ++i) {
    a.sb[i] = (long long)N * 3 * C;
    a.sn[i] = 3LL * C;
    a.sh[i] = D;
  }
  a.out = out;
  a.lsum = lsum;
  a.N = N;
  a.H = H;
  a.D = D;
  constexpr int CH = 16 / sizeof(T);
  a.vec = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && C % CH == 0 && D % CH == 0;
  return attention_heads<T, false>(a, B, s);
}

// Why attention_heads cannot take heads D wide, or nullptr: a block of the
// two-pass instance, its keys streamed, exceeds one block's shared memory.
template <typename T>
const char* attention_shape_error(int D) {
  if (attention_fwd_smem<T>(16 * AttCfg<T>::WARPS, AttCfg<T>::KCH, D) > kSmemMax)
    return sizeof(T) == 2 ? "bf16: the head width exceeds one block's shared memory"
                          : "f32: the head width exceeds one block's shared memory";
  return nullptr;
}

// Why a bf16 layer with heads D wide cannot take the tensor-core path, or
// nullptr. `extra` is the caller's own least shared-memory need at this
// head width.
inline const char* bf16_shape_error(int D, size_t extra) {
  if (attention_shape_error<bf16>(D) != nullptr || extra > kSmemMax)
    return "bf16: the head width exceeds one block's shared memory";
  return nullptr;
}

}  // namespace tc
