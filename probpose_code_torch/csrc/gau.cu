// The gated attention unit's core in RTMPose's head (RTMCCBlock), forward and
// backward, as hand-written CUDA for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package computes the GAU with XLA's
// einsums (probpose_code_tpu/models/utils/rtmcc_block.py:88-108). At the
// whole-body recipes' 133 keypoints the GAU attends over 133 tokens (17 in
// the body recipes), and the block's PyTorch form (about 40 small kernels,
// forward and backward) took 2.36% of an RTMPose-m whole-body train step's
// device time at B = 64 (H100 80GB HBM3, 700 W), so its core is a kernel.
//
// The function, for each batch entry, from the uv projection's output z
// (n tokens x (2e + s): u, v and the shared base, before the activation):
//   a = silu(z); u, v, base = a[:, :e], a[:, e:2e], a[:, 2e:]
//   q = base * gamma[0] + beta[0]; k = base * gamma[1] + beta[1]
//   R = relu(q k^T / sqrt(s)); P = R^2; out = u * (P v)
// and its gradient with respect to z, gamma and beta.
//
// What bounds it on this card: operations. At the whole-body step's shape
// (B = 64, n = 133, e = 512, s = 128, f32) the forward's two products are
// 1.45 GFLOP and the backward's four 2.90, against about 150 MB of inputs
// and outputs. What the design does: one elementwise pass makes the
// products' operands (u and v after the activation, q and k), and every
// product is a 64 x 64 tile a block of 4 warps on the tensor cores in
// 3xTF32 (tile_product), its operands read as they lie, with the rest
// fused into its epilogue: the squared ReLU (R and P kept for the
// backward), the gate u, the activation's derivative. The forward is three
// launches, the backward seven: dO = dout * u with du, the score gradient
// G = 2 R (dO v^T) / sqrt(s), dv, dq = G k, dk = G^T q, the base's
// gradient with gamma's and beta's partial sums over fixed row chunks, and
// the chunks added in a fixed order: no atomics, so two runs give the same
// bits. f32 throughout, as the block runs. Every shipped config's GAU is
// this one: SiLU, no relative position bias, no rotary encoding.

#include <cuda_runtime.h>

#include "tc_tiles.cuh"

namespace {

constexpr int TILE = 64, DEPTH = 16, STAGES = 3, THREADS = 128, PITCH = TILE + 8;
constexpr int PER_THREAD = TILE * DEPTH / THREADS;  // the elements of each operand a thread copies a slice
constexpr int EW_THREADS = 256;
constexpr int RED_COLS = 32, RED_ROWS = 8;

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

__device__ __forceinline__ float silu_grad(float z) {
  const float sig = 1.f / (1.f + expf(-z));
  return sig * (1.f + z * (1.f - sig));
}

// 4 bytes from global to shared memory; a zero where !in (src is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

// One 64 x 64 tile of C (M x N) = A (M x K) B (K x N), the block's tile by
// (blockIdx.y, blockIdx.x); epi(m, n, sum) stores one element. A(m, k) lies
// at A[m lda + k] where A_K_FAST, else at A[k lda + m]; B(k, n) at
// B[n ldb + k] where B_K_FAST, else at B[k ldb + n]. The 16-deep slices of
// A and B go to shared memory by cp.async, in a ring of 3, the copies
// following the contiguous index so that neighbouring threads read
// neighbouring addresses; two slices are in flight while the warps
// multiply a third. There the slices lie (k, m) and (k, n) with a pitch of
// 72 floats, so that a fragment's 32 scalar reads (8 rows or columns by 4
// k) fall on 32 banks. Each of the 4 warps multiplies 32 x 32 outputs on
// the tensor cores in 3xTF32 (tc_tiles.cuh: about 2^-22 relative error a
// product, the f32 FMA's order of error).
template <bool A_K_FAST, bool B_K_FAST, class EPI>
__device__ __forceinline__ void tile_product(int M, int N, int K, const float* __restrict__ A, int lda,
                                             const float* __restrict__ B, int ldb, const EPI& epi) {
  __shared__ float As[STAGES][DEPTH][PITCH];
  __shared__ float Bs[STAGES][DEPTH][PITCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // the warp's 32 x 32 part of the tile
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int slices = (K + DEPTH - 1) / DEPTH;
  float acc[2][4][4] = {};
  auto copy = [&](int slice) {
    const int k0 = slice * DEPTH, stage = slice % STAGES;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      const int ka = A_K_FAST ? idx % DEPTH : idx / TILE, ma = A_K_FAST ? idx / DEPTH : idx % TILE;
      const int kb = B_K_FAST ? idx % DEPTH : idx / TILE, nb = B_K_FAST ? idx / DEPTH : idx % TILE;
      const int m = m0 + ma, n = n0 + nb;
      const bool a_in = m < M && k0 + ka < K, b_in = n < N && k0 + kb < K;
      cp_async4(&As[stage][ka][ma],
                a_in ? A + (A_K_FAST ? (size_t)m * lda + k0 + ka : (size_t)(k0 + ka) * lda + m) : A, a_in);
      cp_async4(&Bs[stage][kb][nb],
                b_in ? B + (B_K_FAST ? (size_t)n * ldb + k0 + kb : (size_t)(k0 + kb) * ldb + n) : B, b_in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) copy(s);
    tc::cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice it has landed, and every warp is done with slice it - 1
    if (it + STAGES - 1 < slices) copy(it + STAGES - 1);
    tc::cp_async_commit();
    const int stage = it % STAGES;
#pragma unroll
    for (int ks = 0; ks < DEPTH; ks += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        const float x[4] = {As[stage][ks + t][r], As[stage][ks + t][r + 8], As[stage][ks + t + 4][r],
                            As[stage][ks + t + 4][r + 8]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const tc::Split sp = tc::split_tf32(x[i]);
          ah[mi][i] = sp.hi;
          al[mi][i] = sp.lo;
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + 8 * ni + g;
        const tc::Split b0 = tc::split_tf32(Bs[stage][ks + t][c]), b1 = tc::split_tf32(Bs[stage][ks + t + 4][c]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) tc::mma3(acc[mi][ni], ah[mi], al[mi], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
        const int m = m0 + wm + 16 * mi + g + 8 * (i / 2), n = n0 + wn + 8 * ni + 2 * t + i % 2;
        if (m < M && n < N) epi(m, n, acc[mi][ni][i]);
      }
}

struct Shape {
  int n, e, s, W;  // tokens, the widths of u (and v) and of the base, z's row (2e + s)
  float root_s;  // sqrt(s) in f32
};

// what the forward keeps for the backward, beside z: a = [u, v] (B n x 2e), q and k (B n x s each),
// R and P = R^2 (B x n x n), O = P v (B n x e)
struct Saved {
  float *a, *q, *k, *R, *P, *O;
};

// a = silu(z[:, :2e]); q, k = silu(z[:, 2e:]) * gamma + beta, over all B n rows: a row's float4s by
// the threads, the rows by the blocks
__global__ void __launch_bounds__(EW_THREADS) activate_kernel(const float* __restrict__ z,
                                                              const float* __restrict__ gamma,
                                                              const float* __restrict__ beta, Saved sv, int rows,
                                                              Shape sh) {
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    for (int c = 4 * threadIdx.x; c < sh.W; c += 4 * EW_THREADS) {
      const float4 zv = __ldg(reinterpret_cast<const float4*>(z + (size_t)r * sh.W + c));
      const float4 x = make_float4(silu(zv.x), silu(zv.y), silu(zv.z), silu(zv.w));
      if (c < 2 * sh.e) {
        *reinterpret_cast<float4*>(sv.a + (size_t)r * 2 * sh.e + c) = x;
      } else {
        const int cs = c - 2 * sh.e;
        const float xs[4] = {x.x, x.y, x.z, x.w};
        float q[4], k[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q[i] = __fadd_rn(__fmul_rn(xs[i], gamma[cs + i]), beta[cs + i]);
          k[i] = __fadd_rn(__fmul_rn(xs[i], gamma[sh.s + cs + i]), beta[sh.s + cs + i]);
        }
        *reinterpret_cast<float4*>(sv.q + (size_t)r * sh.s + cs) = make_float4(q[0], q[1], q[2], q[3]);
        *reinterpret_cast<float4*>(sv.k + (size_t)r * sh.s + cs) = make_float4(k[0], k[1], k[2], k[3]);
      }
    }
  }
}

// R[b] = relu(q k^T / sqrt(s)), P[b] = R^2
__global__ void __launch_bounds__(THREADS) scores_kernel(Saved sv, Shape sh) {
  const size_t b = blockIdx.z, nn = (size_t)sh.n * sh.n;
  float* Rb = sv.R + b * nn;
  float* Pb = sv.P + b * nn;
  tile_product<true, true>(sh.n, sh.n, sh.s, sv.q + b * sh.n * sh.s, sh.s, sv.k + b * sh.n * sh.s, sh.s,
                           [&](int i, int j, float sum) {
                             const float r = fmaxf(sum / sh.root_s, 0.f);
                             Rb[(size_t)i * sh.n + j] = r;
                             Pb[(size_t)i * sh.n + j] = r * r;
                           });
}

// O[b] = P v; out[b] = u * O
__global__ void __launch_bounds__(THREADS) output_kernel(Saved sv, float* __restrict__ out, Shape sh) {
  const size_t b = blockIdx.z;
  const float* ab = sv.a + b * sh.n * 2 * sh.e;
  float* Ob = sv.O + b * sh.n * sh.e;
  float* outb = out + b * sh.n * sh.e;
  tile_product<true, false>(sh.n, sh.e, sh.n, sv.P + b * sh.n * sh.n, sh.n, ab + sh.e, 2 * sh.e,
                            [&](int i, int c, float sum) {
                              Ob[(size_t)i * sh.e + c] = sum;
                              outb[(size_t)i * sh.e + c] = ab[(size_t)i * 2 * sh.e + c] * sum;
                            });
}

// dO = dout * u; dz[:, :e] = dout * O * silu'(z_u), over all B n rows, as activate_kernel runs
__global__ void __launch_bounds__(EW_THREADS) grad_out_kernel(const float* __restrict__ z,
                                                              const float* __restrict__ dout, Saved sv,
                                                              float* __restrict__ dO, float* __restrict__ dz,
                                                              int rows, Shape sh) {
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    for (int c = 4 * threadIdx.x; c < sh.e; c += 4 * EW_THREADS) {
      const size_t i = (size_t)r * sh.e + c, at = (size_t)r * sh.W + c;
      const float4 d = __ldg(reinterpret_cast<const float4*>(dout + i));
      const float4 u = *reinterpret_cast<const float4*>(sv.a + (size_t)r * 2 * sh.e + c);
      const float4 o = *reinterpret_cast<const float4*>(sv.O + i);
      const float4 zu = __ldg(reinterpret_cast<const float4*>(z + at));
      *reinterpret_cast<float4*>(dO + i) = make_float4(d.x * u.x, d.y * u.y, d.z * u.z, d.w * u.w);
      *reinterpret_cast<float4*>(dz + at) =
          make_float4(d.x * o.x * silu_grad(zu.x), d.y * o.y * silu_grad(zu.y),
                      d.z * o.z * silu_grad(zu.z), d.w * o.w * silu_grad(zu.w));
    }
  }
}

// G[b] = 2 R (dO v^T) / sqrt(s): the gradient of q k^T
__global__ void __launch_bounds__(THREADS) grad_scores_kernel(Saved sv, const float* __restrict__ dO,
                                                              float* __restrict__ G, Shape sh) {
  const size_t b = blockIdx.z, nn = (size_t)sh.n * sh.n;
  const float* Rb = sv.R + b * nn;
  float* Gb = G + b * nn;
  tile_product<true, true>(sh.n, sh.n, sh.e, dO + b * sh.n * sh.e, sh.e, sv.a + b * sh.n * 2 * sh.e + sh.e,
                           2 * sh.e, [&](int i, int j, float sum) {
                             Gb[(size_t)i * sh.n + j] = 2.f * Rb[(size_t)i * sh.n + j] * sum / sh.root_s;
                           });
}

// dz[b][:, e:2e] = P^T dO * silu'(z_v)
__global__ void __launch_bounds__(THREADS) grad_values_kernel(const float* __restrict__ z, Saved sv,
                                                              const float* __restrict__ dO, float* __restrict__ dz,
                                                              Shape sh) {
  const size_t b = blockIdx.z;
  const float* zb = z + b * sh.n * sh.W;
  float* dzb = dz + b * sh.n * sh.W;
  tile_product<false, false>(sh.n, sh.e, sh.n, sv.P + b * sh.n * sh.n, sh.n, dO + b * sh.n * sh.e, sh.e,
                             [&](int j, int c, float sum) {
                               const size_t at = (size_t)j * sh.W + sh.e + c;
                               dzb[at] = sum * silu_grad(zb[at]);
                             });
}

// dQK[0][b] = G k (BRANCH 0), dQK[1][b] = G^T q (BRANCH 1)
template <int BRANCH>
__global__ void __launch_bounds__(THREADS) grad_qk_kernel(Saved sv, const float* __restrict__ G,
                                                          float* __restrict__ dQK, int batch, Shape sh) {
  const size_t b = blockIdx.z;
  float* out = dQK + ((size_t)BRANCH * batch + b) * sh.n * sh.s;
  tile_product<BRANCH == 0, false>(sh.n, sh.s, sh.n, G + b * sh.n * sh.n, sh.n,
                                   (BRANCH == 0 ? sv.k : sv.q) + b * sh.n * sh.s, sh.s,
                                   [&](int t, int c, float sum) { out[(size_t)t * sh.s + c] = sum; });
}

// dz[:, 2e:] = (dq gamma[0] + dk gamma[1]) * silu'(z_base) over all B n rows; this block's chunk
// of rows also sums dq * base, dq, dk * base and dk for its 32 columns into partial[chunk][4][s]
__global__ void __launch_bounds__(RED_COLS * RED_ROWS) grad_base_kernel(const float* __restrict__ z,
                                                                        const float* __restrict__ gamma,
                                                                        const float* __restrict__ dQK,
                                                                        float* __restrict__ dz,
                                                                        float* __restrict__ partial, int rows,
                                                                        Shape sh) {
  __shared__ float sums[4][RED_ROWS][RED_COLS];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < sh.s) {
    const float g0 = gamma[c], g1 = gamma[sh.s + c];
    const float* dq = dQK;
    const float* dk = dQK + (size_t)rows * sh.s;
    for (int r = blockIdx.y * RED_ROWS + threadIdx.y; r < rows; r += gridDim.y * RED_ROWS) {
      const size_t at = (size_t)r * sh.W + 2 * sh.e + c;
      const float zv = z[at], x = silu(zv);
      const float q = dq[(size_t)r * sh.s + c], k = dk[(size_t)r * sh.s + c];
      dz[at] = (q * g0 + k * g1) * silu_grad(zv);
      acc[0] += q * x;
      acc[1] += q;
      acc[2] += k * x;
      acc[3] += k;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sums[i][threadIdx.y][threadIdx.x] = acc[i];
  __syncthreads();
  if (threadIdx.y < 4 && c < sh.s) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < RED_ROWS; ++y) total += sums[threadIdx.y][y][threadIdx.x];
    partial[((size_t)blockIdx.y * 4 + threadIdx.y) * sh.s + c] = total;
  }
}

// dgamma[branch][c], dbeta[branch][c] = the chunks' sums, added in order
__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int chunks, int s) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // t = which * s + c: dq * base, dq, dk * base, dk
  if (t >= 4 * s) return;
  float total = 0.f;
  for (int ch = 0; ch < chunks; ++ch) total += partial[(size_t)ch * 4 * s + t];
  const int which = t / s, c = t % s;
  float* dst = (which % 2 == 0) ? dgamma : dbeta;
  dst[(which / 2) * s + c] = total;
}

Shape shape_of(int n, int e, int s) {
  return Shape{n, e, s, 2 * e + s, sqrtf((float)s)};
}

dim3 tiles(int M, int N, int depth) {
  return dim3((unsigned)((N + TILE - 1) / TILE), (unsigned)((M + TILE - 1) / TILE), (unsigned)depth);
}

unsigned ew_blocks(int rows) {
  return (unsigned)(rows < 132 * 16 ? rows : 132 * 16);
}

Saved saved_of(void* a, void* q, void* k, void* R, void* P, void* O) {
  return Saved{static_cast<float*>(a), static_cast<float*>(q), static_cast<float*>(k),
               static_cast<float*>(R), static_cast<float*>(P), static_cast<float*>(O)};
}

}  // namespace

extern "C" {

const char* gau_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The number of row chunks of the backward's partial sums of gamma's and beta's gradient
// (partial: chunks x 4 x s floats).
int gau_chunks(int B, int n) {
  const int rows = B * n;
  const int chunks = (rows + 16 * RED_ROWS - 1) / (16 * RED_ROWS);
  return chunks < 1 ? 1 : (chunks > 128 ? 128 : chunks);
}

// z: B x n x (2e + s); gamma, beta: 2 x s; out: B x n x e; what the backward reads: a (B x n x 2e),
// q, k (B x n x s), R, P (B x n x n), O (B x n x e). Every tensor f32 and contiguous, e and s
// multiples of 4 (the elementwise passes move float4s). Returns 0 or a CUDA error code.
int gau_forward(const void* z, const void* gamma, const void* beta, void* a, void* q, void* k, void* R, void* P,
                void* O, void* out, int B, int n, int e, int s, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 65535 || e % 4 || s % 4) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(n, e, s);
  const Saved sv = saved_of(a, q, k, R, P, O);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * n;
  activate_kernel<<<ew_blocks(rows), EW_THREADS, 0, st>>>(
      static_cast<const float*>(z), static_cast<const float*>(gamma), static_cast<const float*>(beta), sv, rows, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scores_kernel<<<tiles(n, n, B), THREADS, 0, st>>>(sv, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  output_kernel<<<tiles(n, e, B), THREADS, 0, st>>>(sv, static_cast<float*>(out), sh);
  return (int)cudaGetLastError();
}

// dout: B x n x e; z, gamma and a, q, k, R, P, O as the forward left them; scratch dO: B x n x e,
// G: B x n x n, dQK: 2 x B x n x s, partial: gau_chunks(B, n) x 4 x s; dz: B x n x (2e + s); dgamma,
// dbeta: 2 x s. Returns 0 or a CUDA error code.
int gau_backward(const void* z, const void* gamma, const void* dout, void* a, void* q, void* k, void* R, void* P,
                 void* O, void* dO, void* G, void* dQK, void* partial, void* dz, void* dgamma, void* dbeta, int B,
                 int n, int e, int s, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 65535 || e % 4 || s % 4) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(n, e, s);
  const Saved sv = saved_of(a, q, k, R, P, O);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* dOf = static_cast<float*>(dO);
  float* Gf = static_cast<float*>(G);
  float* dQKf = static_cast<float*>(dQK);
  float* dzf = static_cast<float*>(dz);
  const int rows = B * n;
  const int chunks = gau_chunks(B, n);
  grad_out_kernel<<<ew_blocks(rows), EW_THREADS, 0, st>>>(zf, static_cast<const float*>(dout), sv, dOf, dzf,
                                                               rows, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_scores_kernel<<<tiles(n, n, B), THREADS, 0, st>>>(sv, dOf, Gf, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_values_kernel<<<tiles(n, e, B), THREADS, 0, st>>>(zf, sv, dOf, dzf, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_qk_kernel<0><<<tiles(n, s, B), THREADS, 0, st>>>(sv, Gf, dQKf, B, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_qk_kernel<1><<<tiles(n, s, B), THREADS, 0, st>>>(sv, Gf, dQKf, B, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_base_kernel<<<dim3((unsigned)((s + RED_COLS - 1) / RED_COLS), (unsigned)chunks), dim3(RED_COLS, RED_ROWS),
                     0, st>>>(zf, static_cast<const float*>(gamma), dQKf, dzf, static_cast<float*>(partial), rows,
                              sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(4 * s + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial), static_cast<float*>(dgamma),
                                                     static_cast<float*>(dbeta), chunks, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
