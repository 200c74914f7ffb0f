// The tensor-core tile engine shared by the bf16 instances of K1
// (vit_layer.cu) and K3 (vit_layer_train.cu), for Hopper (sm_90a).
//
// Every product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16
// operands, f32 accumulation. Fragments come from shared memory through
// ldmatrix (.trans for an operand stored the other way round), and shared
// memory is fed by 16-byte cp.async.cg copies whose src-size operand
// zero-fills the ragged edges. Rows in shared memory are padded by 16 bytes,
// so the eight rows of one ldmatrix fall on eight different 16-byte bank
// groups.
//
// Two engines:
//  - gemm: out[M, N] = op(A)[M, K] @ op(B)[K, N] with a fused epilogue that
//    sees the f32 accumulators in pairs of columns. Layouts NN (A (M, K),
//    B (K, N)), NT (B stored (N, K): dx = dY W^T) and TN (A stored (K, M):
//    dW = X^T dY). Block tiles 128x128 with 8 warps of 64x32, or 128x64
//    with 8 warps of 32x32 where the larger tile's grid would fill fewer
//    than two waves; a 3-stage cp.async ring of 32-deep k slices. A TN
//    product may be split along K into partial products (blockIdx.z). Any
//    shape: an operand whose rows are a multiple of 8 elements long goes by
//    16-byte copies, each wholly inside or wholly outside the matrix; one
//    whose rows are not (an MLP width such as 100) goes element by element,
//    zero-filled past its edges. With an odd N the pair (n, n + 1) may end
//    past the matrix: the epilogue takes care of it.
//  - attention forward: p = exp(min(q.k, 80)) / sum, rounded to bf16 after
//    the division as the TPU kernel rounds it, then p @ v, per (image, head)
//    of a (B*N, 3C) qkv; also the row sums, for K3's backward. One block per
//    64 queries of an (image, head), 4 warps of 16 queries. At N <= 192 and
//    head widths up to 64 (the 256x192 crops), K and V sit whole in shared
//    memory (v's copy lands while the scores are computed) and the key row
//    stays in registers: one pass, each score computed once. Otherwise two
//    passes over 32-key chunks, K and V whole in shared memory where they
//    fit and streamed a chunk at a time where they do not, and the output
//    computed 64 columns at a time; heads up to 896 wide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !in (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}

// dst[0, 8) = src[0, run), zeros from run on; a plain load and store each
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int run) {
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = e < run ? src[e] : __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
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
        copy8(as + r * G::A_P + c, src, run);
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
        copy8(bs + r * G::B_P + c, src, run);
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

// One product over the whole K: 128x128 tiles where their grid fills two
// waves of two blocks an SM, else 128x64.
template <int L, class Epi>
cudaError_t gemm(const bf16* A, const bf16* B, const Epi& epi, int M, int N, int K, cudaStream_t s) {
  const long big = (long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= 2 * 2 * kSMs) return gemm_launch<GemmBig<L>>(A, B, epi, M, N, K, K, 1, s);
  return gemm_launch<GemmSmall<L>>(A, B, epi, M, N, K, K, 1, s);
}

// ---------------------------------------------------------------------------
// Attention building blocks: a warp owns 16 rows; rows of q, k, v, dO sit in
// shared memory at pitch P = DP + 8 elements, DP = D rounded up to 16 with
// zero columns. The rows a block sweeps (keys; queries on the key side of
// the backward) sit whole in shared memory where they fit ("resident"), else
// they stream through it a chunk at a time. An output wider than a kernel's
// DMAX columns is computed DMAX columns at a time, its scores recomputed for
// each.
// ---------------------------------------------------------------------------
constexpr int ATT_ROWS = 64, ATT_WARPS = 4, ATT_THREADS = ATT_WARPS * 32;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int att_pitch(int D) { return round16(D) + 8; }

// dst[r * P + c] = src[(r0 + r) * rs + col0 + c] for r < rows, c < DP; zeros
// past N rows and past D columns
__device__ __forceinline__ void load_head_rows(bf16* dst, int P, const bf16* src, size_t rs, int col0, int r0,
                                               int rows, int N, int D, int tid) {
  const int cpr = round16(D) / 8;
  for (int i = tid; i < rows * cpr; i += ATT_THREADS) {
    const int r = i / cpr, c = (i % cpr) * 8, n = r0 + r;
    const bool in = n < N && c < D;
    cp_async16(dst + r * P + c, in ? src + (size_t)n * rs + col0 + c : src, in);
  }
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

// rows r, r + 8 of a warp's accumulators (columns [0, D)) to row-major dst
template <int DT, typename Tout>
__device__ __forceinline__ void store_rows(Tout* dst, size_t pitch, const float (&acc)[DT][4], int r, int N,
                                           int D, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (d >= D) break;
    if (r < N) store2(dst + (size_t)r * pitch + d, acc[dt][0], acc[dt][1]);
    if (r + 8 < N) store2(dst + (size_t)(r + 8) * pitch + d, acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// Attention forward. qkv (B*N, 3C), out (B*N, C), lsum (B*N, H) or null.
// ---------------------------------------------------------------------------
constexpr int ATT_KCH = 32;  // keys a chunk of the general instance

// shared memory of a block whose keys and values take `rows` rows each
__host__ __device__ __forceinline__ size_t attention_fwd_smem(int rows, int D) {
  return (size_t)(ATT_ROWS + 2 * rows) * att_pitch(D) * 2;
}

// KCH keys a chunk, DMAX output columns at a time, KD as in mma_abt. Where
// N <= KCH and D <= DMAX, one pass: the scores stay in registers. Otherwise
// two passes over key chunks: the row sums, then p @ v for each chunk of
// DMAX output columns. Four blocks an SM (at most 128 registers a thread):
// the kernel is bound by latency, not by its few operations, and occupancy
// hides it better than the registers the compiler would otherwise take.
template <int KCH, int DMAX, int KD>
__global__ void __launch_bounds__(ATT_THREADS, 4)
attention_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, float* __restrict__ lsum, int N, int C,
                     int H, int D, int resident) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int DP = round16(D), P = att_pitch(D), NP = round16(N);
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ks = qs + ATT_ROWS * P;
  bf16* vs = ks + (resident ? NP : KCH) * P;
  const int q0 = blockIdx.x * ATT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * rs;
  const int kc = C + h * D, vc = 2 * C + h * D;

  // q and, resident, k first; v lands while the scores are computed
  load_head_rows(qs, P, base, rs, h * D, q0, ATT_ROWS, N, D, tid);
  if (resident) {
    load_head_rows(ks, P, base, rs, kc, 0, NP, N, D, tid);
    cp_async_commit();
    load_head_rows(vs, P, base, rs, vc, 0, NP, N, D, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // where keys [c0, c0 + KCH) sit in ks and vs: resident, or copied in now
  auto chunk = [&](int c0, bool with_v) {
    if (resident) return c0 * P;
    __syncthreads();  // every warp is done with the previous chunk
    load_head_rows(ks, P, base, rs, kc, c0, KCH, N, D, tid);
    if (with_v) load_head_rows(vs, P, base, rs, vc, c0, KCH, N, D, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    return 0;
  };

  const bf16* qw = qs + warp * 16 * P;
  float s[KCH / 8][4];
  float o[DMAX / 8][4];
  float l0 = 0.f, l1 = 0.f;      // rows g and g + 8
  float inv0 = 1.f, inv1 = 1.f;  // their reciprocals

  auto scores = [&](int ko, int c0) {
    zero(s);
    mma_abt<KCH / 16, KD>(s, qw, ks + ko, P, DP, N - c0, lane);
    exp_clamp_mask(s, c0, N, lane);
  };
  auto rowsum = [&]() {
#pragma unroll
    for (int j = 0; j < KCH / 8; ++j) {
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  };
  // o += p @ v[:, dc0:]; p = s / l, rounded to bf16 (in mma_ab) after the division
  auto pv = [&](int ko, int c0, int dc0) {
#pragma unroll
    for (int j = 0; j < KCH / 8; ++j) {
      s[j][0] = div_by(s[j][0], l0, inv0);
      s[j][1] = div_by(s[j][1], l0, inv0);
      s[j][2] = div_by(s[j][2], l1, inv1);
      s[j][3] = div_by(s[j][3], l1, inv1);
    }
    mma_ab<KCH / 16, DMAX>(o, s, vs + ko + dc0, P, DP - dc0, N - c0, lane);
  };

  const int r = q0 + warp * 16 + (lane >> 2);
  bf16* orow = out + (size_t)b * N * C + h * D;
  if (N <= KCH && D <= DMAX) {  // one pass (resident): the scores stay in registers
    scores(0, 0);
    rowsum();
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
    cp_async_wait<0>();
    __syncthreads();
    zero(o);
    pv(0, 0, 0);
    store_rows(orow, (size_t)C, o, r, N, D, lane);
  } else {
    for (int c0 = 0; c0 < N; c0 += KCH) {
      scores(chunk(c0, false), c0);
      rowsum();
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
    cp_async_wait<0>();
    __syncthreads();
    for (int dc0 = 0; dc0 < D; dc0 += DMAX) {
      zero(o);
      for (int c0 = 0; c0 < N; c0 += KCH) {
        const int ko = chunk(c0, true);
        scores(ko, c0);
        pv(ko, c0, dc0);
      }
      store_rows(orow + dc0, (size_t)C, o, r, N, D - dc0, lane);
    }
  }
  if (lsum != nullptr && (lane & 3) == 0) {
    if (r < N) lsum[((size_t)b * N + r) * H + h] = l0;
    if (r + 8 < N) lsum[((size_t)b * N + r + 8) * H + h] = l1;
  }
}

template <class Kern>
cudaError_t launch_attention_kernel(Kern kernel, dim3 grid, size_t smem, cudaStream_t s, const bf16* qkv, bf16* out,
                                    float* lsum, int N, int C, int H, int D, int resident) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, ATT_THREADS, smem, s>>>(qkv, out, lsum, N, C, H, D, resident);
  return cudaGetLastError();
}

inline cudaError_t attention_fwd(const bf16* qkv, bf16* out, float* lsum, int B, int N, int C, int H,
                                 cudaStream_t s) {
  const int D = C / H, NP = round16(N);
  const dim3 grid((N + ATT_ROWS - 1) / ATT_ROWS, H, B);
  // one pass with the key row in registers up to 192 keys (the 256x192
  // crops' 16x16 patches) at head widths up to 64
  if (N <= 192 && round16(D) <= 64)
    return launch_attention_kernel(attention_fwd_kernel<192, 64, 64>, grid, attention_fwd_smem(NP, D), s, qkv, out,
                                   lsum, N, C, H, D, 1);
  const int resident = attention_fwd_smem(NP, D) <= kSmemMax;
  return launch_attention_kernel(attention_fwd_kernel<ATT_KCH, 64, 0>, grid,
                                 attention_fwd_smem(resident ? NP : ATT_KCH, D), s, qkv, out, lsum, N, C, H, D,
                                 resident);
}

// Why a bf16 layer with heads D wide cannot take the tensor-core path, or
// nullptr. `extra` is the caller's own least shared-memory need at this
// head width.
inline const char* bf16_shape_error(int D, size_t extra) {
  if (attention_fwd_smem(ATT_KCH, D) > kSmemMax || extra > kSmemMax)
    return "bf16: the head width exceeds one block's shared memory";
  return nullptr;
}

}  // namespace tc
