// The differentiable pre-norm ViT layer for training, as hand-written CUDA
// for Hopper (sm_90a): one forward and one backward entry.
//
// Replaces the TPU kernel probpose_code_tpu/ops/pallas/vit_layer_train.py:
// vit_layer_train (_fwd_kernel, _bwd_mlp_kernel, _bwd_attn_kernel) and
// computes that kernel's math, casts included:
//
//   forward   xn1 = LN1(x); qkv = xn1 @ Wqkv + bqkv (q-scale folded in by
//             the caller); attn = softmax-clamp(q.k) @ v per image and head,
//             p = exp(min(s, 80)) / sum with no max shift;
//             x1  = x + m1 * (attn @ Wp + bp)            (f32, saved)
//             out = x1 + m2 * (gelu_tanh(LN2(x1) @ W1 + b1) @ W2 + b2)
//   backward  MLP half:  dbr = g*m2 -> db2, dW2, dh, dhpre = dh*gelu'(hpre)
//             -> db1, dW1, dxn2 -> LN2 grads, dx1 = g + LN_bwd(dxn2*l2s)
//             attention half: dbr = dx1*m1 -> dbp, dWp, dO = dbr @ Wp^T;
//             per head and image ds = p*(dp - rowsum(dp*p)) with p
//             recomputed unshifted -> dq, dk, dv; dbqkv, dWqkv, dxn1 -> LN1
//             grads, dx = dx1 + LN_bwd(dxn1*l1s)
//
// m1, m2 are per-image stochastic-depth multipliers (0 or 1/keep). Operands
// are T (bf16 or f32) and every product accumulates in f32; p, dO, ds, the
// masked branch gradients and dhpre are rounded to T before their products,
// where the TPU kernel rounds them. LN statistics are E[x^2] - mean^2,
// unclamped, as in the TPU kernel.
//
// Design. The TPU kernel keeps a group of images in VMEM and recomputes qkv,
// the MLP hidden and p in its backward; its weight gradients accumulate
// across a sequential grid. Here blocks run in parallel and in no order, and
// a whole layer does not fit one block's shared memory, so:
//  - the forward saves what the backward needs (LN outputs, qkv, attn, x1,
//    the f32 pre-GELU hidden, the hidden, and the softmax row sums l): about
//    190 MB a layer at B = 64, N = 192, C = 384, F = 1536. Only p (113 MB a
//    layer in f32) is recomputed, tile by tile, in the two attention-backward
//    kernels, from the saved l;
//  - every weight gradient is one product X^T dY over the T = B*N rows,
//    split along T into a few partial products and summed in a second pass
//    in a fixed order; bias and LN gradients are column sums done the same
//    way. No atomics: the result does not depend on the order of blocks, and
//    two runs on the same inputs give the same bits.
//
// What bounds it: operations. At the flagship shape a layer's forward is
// 47.1 GFLOP and the least a backward can do is twice that, 94.2 GFLOP,
// against about 0.1 GB of inputs and outputs: 0.048 and 0.095 ms at
// 989 TFLOP/s in bf16. What the design does about it:
//  - bf16: every product runs on the tensor cores through the shared tile
//    engine (tc_tiles.cuh): the forward's and the dx products as NN / NT
//    GEMMs with the epilogues on the accumulators, the weight gradients as
//    split TN GEMMs, and the attention forward and both attention-backward
//    kernels as mma.sync tiles (S, dP = dO V^T, dQ = dS K, dK = dS^T Q,
//    dV = P^T dO, the last two through ldmatrix.trans);
//  - f32: the products run on the FMA units from shared-memory tiles (64x64
//    outputs, 4x4 a thread). Its bars (2e-4 forward, 5e-4 gradients) rule
//    out single-pass TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "tc_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(kSqrt2OverPi * (x + kGeluC * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kSqrt2OverPi * (x + kGeluC * x * x * x));
  const float du = kSqrt2OverPi * (1.0f + 3.0f * kGeluC * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// ---------------------------------------------------------------------------
// LayerNorm forward and backward: one warp per row, statistics in f32.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;

template <typename Tin>
__device__ __forceinline__ void row_stats(const Tin* xr, int C, float eps, int lane,
                                          float& mean, float& sinv) {
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = s / (float)C;
  sinv = rsqrtf(ss / (float)C - mean * mean + eps);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ y, int M, int C, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const Tin* xr = x + (size_t)row * C;
  float mean, sinv;
  row_stats(xr, C, eps, lane, mean, sinv);
  Tout* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    yr[c] = from_f<Tout>((to_f(xr[c]) - mean) * sinv * scale[c] + bias[c]);
  }
}

// dx = resid + sinv * (dys - mean(dys) - xhat * mean(dys * xhat)), dys = dxn * scale;
// prod = dxn * xhat feeds the column sum that is the scale's gradient.
template <typename Tin, typename Tres, typename Tout>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_backward_kernel(const Tin* __restrict__ x, const float* __restrict__ dxn,
                          const float* __restrict__ scale, const Tres* __restrict__ resid,
                          Tout* __restrict__ dx, float* __restrict__ prod, int M, int C, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t o = (size_t)row * C;
  float mean, sinv;
  row_stats(x + o, C, eps, lane, mean, sinv);
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (to_f(x[o + c]) - mean) * sinv;
    const float dys = dxn[o + c] * scale[c];
    m1 += dys;
    m2 += dys * xhat;
  }
  m1 = warp_sum(m1) / (float)C;
  m2 = warp_sum(m2) / (float)C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (to_f(x[o + c]) - mean) * sinv;
    const float g = dxn[o + c];
    dx[o + c] = from_f<Tout>(to_f(resid[o + c]) + sinv * (g * scale[c] - m1 - xhat * m2));
    prod[o + c] = g * xhat;
  }
}

// ---------------------------------------------------------------------------
// GEMM epilogues, shared by the f32 FMA GEMM and the bf16 tensor-core one.
// C[M, N] = op(A)[M, K] @ op(B)[K, N]; TA: A is stored (K, M); TB: B is
// stored (N, K). A product split along K (blockIdx.z) writes its partial
// products with the f32 epilogue at out + z * M * N.
// ---------------------------------------------------------------------------
enum Epilogue { EPI_QKV, EPI_PROJ, EPI_FC1, EPI_FC2, EPI_DH, EPI_F32, EPI_CAST };

struct EpiArgs {
  const float* bias;  // QKV, PROJ, FC1, FC2
  const float* mask;  // PROJ, FC2: per image, row m -> mask[m / tokens]
  int tokens;
  const void* res;    // PROJ: x (T); FC2: x1 (f32); DH: hpre (f32)
  void* out;          // QKV: qkv (T); PROJ: x1 (f32); FC1: hpre (f32); FC2: out (T);
                      // DH: dhpre (f32); F32: f32; CAST: T
  void* out2;         // FC1: hidden (T); DH: dhpre rounded to T
};

// W outputs (m, n), (m, n + 1), ... at offset o (z_off: the K split's
// partial products), rounded where the TPU kernel rounds them
template <int W> __device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if (W == 1) p[0] = v[0]; else tc::store2(p, v[0], v[W - 1]);
}
template <int W> __device__ __forceinline__ void store_w(bf16* p, const float (&v)[W]) {
  if (W == 1) p[0] = __float2bfloat16(v[0]); else tc::store2(p, v[0], v[W - 1]);
}

template <typename T, int EPI, int W>
__device__ __forceinline__ void epilogue(const EpiArgs& e, int m, int n, size_t o, size_t z_off,
                                         const float (&v)[W]) {
  static_assert(W == 1 || W == 2, "one output or a pair");
  float r[W], r2[W] = {};
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const size_t oi = o + i;
    if (EPI == EPI_QKV) {
      r[i] = v[i] + e.bias[n + i];
    } else if (EPI == EPI_PROJ) {
      r[i] = to_f(static_cast<const T*>(e.res)[oi]) + e.mask[m / e.tokens] * (v[i] + e.bias[n + i]);
    } else if (EPI == EPI_FC1) {
      r[i] = v[i] + e.bias[n + i];
      r2[i] = gelu_tanh(r[i]);
    } else if (EPI == EPI_FC2) {
      r[i] = static_cast<const float*>(e.res)[oi] + e.mask[m / e.tokens] * (v[i] + e.bias[n + i]);
    } else if (EPI == EPI_DH) {
      r[i] = v[i] * gelu_tanh_grad(static_cast<const float*>(e.res)[oi]);
      r2[i] = r[i];
    } else {
      r[i] = v[i];
    }
  }
  if (EPI == EPI_PROJ || EPI == EPI_FC1 || EPI == EPI_DH) {
    store_w<W>(static_cast<float*>(e.out) + o, r);  // x1, hpre, dhpre in f32
  } else if (EPI == EPI_F32) {
    store_w<W>(static_cast<float*>(e.out) + z_off + o, r);
  } else {
    store_w<W>(static_cast<T*>(e.out) + o, r);  // qkv, out, dO rounded to T
  }
  if (EPI == EPI_FC1 || EPI == EPI_DH) store_w<W>(static_cast<T*>(e.out2) + o, r2);  // hidden, dhpre_c
}

// ---------------------------------------------------------------------------
// f32 GEMM on the FMA units: 64x64 output tile per block of 256 threads, 4x4
// outputs a thread strided by 16. Ragged edges are zero-filled on load and
// masked on store.
// ---------------------------------------------------------------------------
constexpr int GBM = 64, GBN = 64, GBK = 16, GTHREADS = 256;

template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Bm, EpiArgs e,
                int M, int N, int K, int k_chunk) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += GBK) {
#pragma unroll
    for (int i = 0; i < (GBM * GBK) / GTHREADS; ++i) {
      const int idx = tid + i * GTHREADS;
      // neighbouring threads on neighbouring addresses for either layout
      const int ar = TA ? idx % GBM : idx / GBK;
      const int ak = TA ? idx / GBM : idx % GBK;
      const int gm = m0 + ar, gk = k0 + ak;
      float a = 0.f;
      if (gm < M && gk < kend) a = TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      As[ak][ar] = a;
      const int bk = TB ? idx % GBK : idx / GBN;
      const int bc = TB ? idx / GBK : idx % GBN;
      const int gk2 = k0 + bk, gn = n0 + bc;
      float b = 0.f;
      if (gk2 < kend && gn < N) b = TB ? Bm[(size_t)gn * K + gk2] : Bm[(size_t)gk2 * N + gn];
      Bs[bk][bc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float v[1] = {acc[i][j]};
      epilogue<float, EPI, 1>(e, m, n, (size_t)m * N + n, (size_t)blockIdx.z * M * N, v);
    }
  }
}

// The tensor-core GEMM's epilogue: a pair of columns (n, n + 1), stored
// together where N is even; one at a time where it is odd (the pair is then
// misaligned and may end past the row).
template <int EPI>
struct TcEpilogue {
  EpiArgs e;
  int M, N;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const size_t o = (size_t)m * N + n, z_off = (size_t)blockIdx.z * M * N;
    if (N % 2 == 0) {
      const float v[2] = {v0, v1};
      epilogue<bf16, EPI, 2>(e, m, n, o, z_off, v);
      return;
    }
    const float a[1] = {v0};
    epilogue<bf16, EPI, 1>(e, m, n, o, z_off, a);
    if (n + 1 < N) {
      const float c[1] = {v1};
      epilogue<bf16, EPI, 1>(e, m, n + 1, o + 1, z_off, c);
    }
  }
};

// out[i] = sum over s of part[s * n + i], s in order
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Column sums over the T rows (bias and LN gradients): block (32 columns,
// 8 row lanes) sums one chunk of rows into part[chunk * C + col]; the chunks
// are then summed in order by sum_partials_kernel.
// ---------------------------------------------------------------------------
constexpr int CS_ROWS = 256;

template <typename Tin>
__global__ void __launch_bounds__(256)
colsum_kernel(const Tin* __restrict__ a, const float* __restrict__ mask, int tokens,
              float* __restrict__ part, int M, int C) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * CS_ROWS;
  const int r1 = min(M, r0 + CS_ROWS);
  float s = 0.f;
  if (col < C) {
    for (int r = r0 + ty; r < r1; r += 8) {
      const float v = to_f(a[(size_t)r * C + col]);
      s += mask ? v * mask[r / tokens] : v;
    }
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][tx];
    part[(size_t)blockIdx.y * C + col] = t;
  }
}

// out = in * mask[row / tokens], rounded to T (the masked branch gradient)
template <typename Tin, typename T>
__global__ void mask_cast_kernel(const Tin* __restrict__ in, const float* __restrict__ mask,
                                 T* __restrict__ out, size_t n, int C, int tokens) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(i / C);
    out[i] = from_f<T>(to_f(in[i]) * mask[row / tokens]);
  }
}

// ---------------------------------------------------------------------------
// f32 attention forward: K1's f32 kernel. One block per (query tile of 32,
// head, image); 4 warps of 8 queries; keys stream through shared memory in
// tiles of 32, one key per lane. Pass 1 sums exp(min(s, 80)) (written to
// lsum for the backward); pass 2 recomputes each score, normalises p and
// accumulates p @ v with the lanes over the head dims (chunks of 128).
// ---------------------------------------------------------------------------
constexpr int ATT_WARPS = 4, ATT_QPW = 8, ATT_QT = ATT_WARPS * ATT_QPW;
constexpr int ATT_KT = 32, ATT_DC = 128, ATT_THREADS = ATT_WARPS * 32;

size_t attention_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)ATT_QT * D + (size_t)ATT_KT * (D + 1) + (size_t)ATT_KT * ATT_DC +
          (size_t)ATT_QT * ATT_KT);
}

__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* base, size_t rs, int col0,
                                          int n0, int rows, int N, int width, int tid) {
  // dst[r * pitch + d] = base[(n0 + r) * rs + col0 + d], zero past N
  for (int i = tid; i < rows * width; i += ATT_THREADS) {
    const int r = i / width, d = i % width, n = n0 + r;
    dst[r * pitch + d] = n < N ? base[(size_t)n * rs + col0 + d] : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__global__ void __launch_bounds__(ATT_THREADS)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lsum,
                     int N, int C, int H, int D) {
  extern __shared__ float smem[];
  float* qs = smem;                           // ATT_QT x D
  float* ks = qs + ATT_QT * D;                // ATT_KT x (D + 1)
  float* vs = ks + ATT_KT * (D + 1);          // ATT_KT x ATT_DC
  float* ps = vs + ATT_KT * ATT_DC;           // ATT_QT x ATT_KT

  const int q0 = blockIdx.x * ATT_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = (size_t)3 * C;
  const float* base = qkv + (size_t)b * N * rs;
  const int Dp = D + 1;

  load_rows(qs, D, base, rs, h * D, q0, ATT_QT, N, D, tid);

  float rsum[ATT_QPW];
#pragma unroll
  for (int qq = 0; qq < ATT_QPW; ++qq) rsum[qq] = 0.f;
  for (int k0 = 0; k0 < N; k0 += ATT_KT) {
    __syncthreads();
    load_rows(ks, Dp, base, rs, C + h * D, k0, ATT_KT, N, D, tid);
    __syncthreads();
    if (k0 + lane < N) {
#pragma unroll
      for (int qq = 0; qq < ATT_QPW; ++qq)
        rsum[qq] += expf(fminf(dot_rows(qs + (warp * ATT_QPW + qq) * D, ks + lane * Dp, D), 80.f));
    }
  }
#pragma unroll
  for (int qq = 0; qq < ATT_QPW; ++qq) rsum[qq] = warp_sum(rsum[qq]);

  for (int dc0 = 0; dc0 < D; dc0 += ATT_DC) {
    const int dcn = min(ATT_DC, D - dc0);
    float acc[ATT_QPW][ATT_DC / 32];
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq)
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) acc[qq][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += ATT_KT) {
      __syncthreads();
      load_rows(ks, Dp, base, rs, C + h * D, k0, ATT_KT, N, D, tid);
      load_rows(vs, ATT_DC, base, rs, 2 * C + h * D + dc0, k0, ATT_KT, N, dcn, tid);
      __syncthreads();
#pragma unroll
      for (int qq = 0; qq < ATT_QPW; ++qq) {
        float p = 0.f;
        if (k0 + lane < N) {
          const float s = dot_rows(qs + (warp * ATT_QPW + qq) * D, ks + lane * Dp, D);
          p = expf(fminf(s, 80.f)) / rsum[qq];
        }
        ps[(warp * ATT_QPW + qq) * ATT_KT + lane] = p;
      }
      __syncwarp();
      for (int kj = 0; kj < ATT_KT; ++kj) {
#pragma unroll
        for (int c = 0; c < ATT_DC / 32; ++c) {
          if (32 * c >= dcn) break;
          const float v = lane + 32 * c < dcn ? vs[kj * ATT_DC + lane + 32 * c] : 0.f;
#pragma unroll
          for (int qq = 0; qq < ATT_QPW; ++qq)
            acc[qq][c] = fmaf(ps[(warp * ATT_QPW + qq) * ATT_KT + kj], v, acc[qq][c]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq) {
      const int n = q0 + warp * ATT_QPW + qq;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < dcn) out[((size_t)b * N + n) * C + h * D + dc0 + d] = acc[qq][c];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq) {
      const int n = q0 + warp * ATT_QPW + qq;
      if (n < N) lsum[((size_t)b * N + n) * H + h] = rsum[qq];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 attention backward, query side: one block per (query tile, head,
// image), with the forward's row sums l. Pass 1: delta_i = sum_j p_ij dp_ij
// with dp_ij = dO_i . v_j. Pass 2 (per chunk of 128 dims): ds = p * (dp -
// delta), dq_i += ds_ij k_j. Writes dq into columns [h*D, h*D + D) of dqkv
// (f32 and T), and delta per (row, head) for the key-side kernel.
// ---------------------------------------------------------------------------
size_t attn_bwd_q_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)2 * ATT_QT * D + (size_t)2 * ATT_KT * (D + 1) + (size_t)ATT_QT * ATT_KT);
}

__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_q_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO, const float* __restrict__ lsum,
                      float* __restrict__ dqkv, float* __restrict__ dqkv_c, float* __restrict__ delta,
                      int N, int C, int H, int D) {
  extern __shared__ float smem[];
  float* qs = smem;                      // ATT_QT x D
  float* dos = qs + ATT_QT * D;          // ATT_QT x D
  float* ks = dos + ATT_QT * D;          // ATT_KT x (D + 1)
  float* vs = ks + ATT_KT * (D + 1);     // ATT_KT x (D + 1)
  float* dss = vs + ATT_KT * (D + 1);    // ATT_QT x ATT_KT

  const int q0 = blockIdx.x * ATT_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = (size_t)3 * C;
  const float* base = qkv + (size_t)b * N * rs;
  const float* dbase = dO + (size_t)b * N * C;
  const int Dp = D + 1;

  load_rows(qs, D, base, rs, h * D, q0, ATT_QT, N, D, tid);
  load_rows(dos, D, dbase, (size_t)C, h * D, q0, ATT_QT, N, D, tid);

  float l[ATT_QPW], dl[ATT_QPW];
#pragma unroll
  for (int qq = 0; qq < ATT_QPW; ++qq) {
    const int n = q0 + warp * ATT_QPW + qq;
    l[qq] = n < N ? lsum[((size_t)b * N + n) * H + h] : 1.f;
    dl[qq] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += ATT_KT) {
    __syncthreads();
    load_rows(ks, Dp, base, rs, C + h * D, k0, ATT_KT, N, D, tid);
    load_rows(vs, Dp, base, rs, 2 * C + h * D, k0, ATT_KT, N, D, tid);
    __syncthreads();
    if (k0 + lane < N) {
#pragma unroll
      for (int qq = 0; qq < ATT_QPW; ++qq) {
        const int qi = warp * ATT_QPW + qq;
        const float p = expf(fminf(dot_rows(qs + qi * D, ks + lane * Dp, D), 80.f)) / l[qq];
        dl[qq] += p * dot_rows(dos + qi * D, vs + lane * Dp, D);
      }
    }
  }
#pragma unroll
  for (int qq = 0; qq < ATT_QPW; ++qq) dl[qq] = warp_sum(dl[qq]);

  for (int dc0 = 0; dc0 < D; dc0 += ATT_DC) {
    const int dcn = min(ATT_DC, D - dc0);
    float acc[ATT_QPW][ATT_DC / 32];
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq)
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) acc[qq][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += ATT_KT) {
      __syncthreads();
      load_rows(ks, Dp, base, rs, C + h * D, k0, ATT_KT, N, D, tid);
      load_rows(vs, Dp, base, rs, 2 * C + h * D, k0, ATT_KT, N, D, tid);
      __syncthreads();
#pragma unroll
      for (int qq = 0; qq < ATT_QPW; ++qq) {
        const int qi = warp * ATT_QPW + qq;
        float ds = 0.f;
        if (k0 + lane < N) {
          const float p = expf(fminf(dot_rows(qs + qi * D, ks + lane * Dp, D), 80.f)) / l[qq];
          const float dp = dot_rows(dos + qi * D, vs + lane * Dp, D);
          ds = p * (dp - dl[qq]);
        }
        dss[qi * ATT_KT + lane] = ds;
      }
      __syncwarp();
      for (int kj = 0; kj < ATT_KT; ++kj) {
#pragma unroll
        for (int c = 0; c < ATT_DC / 32; ++c) {
          if (32 * c >= dcn) break;
          const float kv = lane + 32 * c < dcn ? ks[kj * Dp + dc0 + lane + 32 * c] : 0.f;
#pragma unroll
          for (int qq = 0; qq < ATT_QPW; ++qq)
            acc[qq][c] = fmaf(dss[(warp * ATT_QPW + qq) * ATT_KT + kj], kv, acc[qq][c]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq) {
      const int n = q0 + warp * ATT_QPW + qq;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) {
        const int d = lane + 32 * c;
        if (d >= dcn) continue;
        const size_t o = ((size_t)b * N + n) * rs + h * D + dc0 + d;
        dqkv[o] = acc[qq][c];
        dqkv_c[o] = acc[qq][c];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int qq = 0; qq < ATT_QPW; ++qq) {
      const int n = q0 + warp * ATT_QPW + qq;
      if (n < N) delta[((size_t)b * N + n) * H + h] = dl[qq];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 attention backward, key side: one block per (key tile of 32, head,
// image); 4 warps of 8 keys. Queries stream through shared memory in tiles
// of 32, one query per lane: p_ij from the stored l_i, ds = p * (dp -
// delta_i); then, with the lanes over the head dims, dv_j += p_ij dO_i and
// dk_j += ds_ij q_i. Writes dk and dv into columns C + h*D and 2C + h*D.
// ---------------------------------------------------------------------------
size_t attn_bwd_kv_smem_bytes(int D) {
  return sizeof(float) * ((size_t)2 * ATT_QT * D + (size_t)2 * ATT_KT * (D + 1) +
                          (size_t)2 * ATT_KT + (size_t)2 * ATT_QT * ATT_KT);
}

__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                       const float* __restrict__ lsum, const float* __restrict__ delta,
                       float* __restrict__ dqkv, float* __restrict__ dqkv_c, int N, int C, int H, int D) {
  extern __shared__ float smem[];
  float* kb = smem;                      // ATT_QT keys x D (this block's keys)
  float* vb = kb + ATT_QT * D;           // ATT_QT keys x D
  float* qt = vb + ATT_QT * D;           // ATT_KT queries x (D + 1)
  float* dot_ = qt + ATT_KT * (D + 1);   // ATT_KT queries x (D + 1)
  float* lt = dot_ + ATT_KT * (D + 1);   // ATT_KT
  float* dt = lt + ATT_KT;               // ATT_KT
  float* pcs = dt + ATT_KT;              // ATT_QT keys x ATT_KT queries
  float* dss = pcs + ATT_QT * ATT_KT;    // ATT_QT keys x ATT_KT queries

  const int j0 = blockIdx.x * ATT_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = (size_t)3 * C;
  const float* base = qkv + (size_t)b * N * rs;
  const float* dbase = dO + (size_t)b * N * C;
  const int Dp = D + 1;

  load_rows(kb, D, base, rs, C + h * D, j0, ATT_QT, N, D, tid);
  load_rows(vb, D, base, rs, 2 * C + h * D, j0, ATT_QT, N, D, tid);

  for (int dc0 = 0; dc0 < D; dc0 += ATT_DC) {
    const int dcn = min(ATT_DC, D - dc0);
    float ak[ATT_QPW][ATT_DC / 32], av[ATT_QPW][ATT_DC / 32];
#pragma unroll
    for (int kk = 0; kk < ATT_QPW; ++kk)
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) ak[kk][c] = av[kk][c] = 0.f;

    for (int i0 = 0; i0 < N; i0 += ATT_KT) {
      __syncthreads();
      load_rows(qt, Dp, base, rs, h * D, i0, ATT_KT, N, D, tid);
      load_rows(dot_, Dp, dbase, (size_t)C, h * D, i0, ATT_KT, N, D, tid);
      if (tid < ATT_KT) {
        const int i = i0 + tid;
        lt[tid] = i < N ? lsum[((size_t)b * N + i) * H + h] : 1.f;
        dt[tid] = i < N ? delta[((size_t)b * N + i) * H + h] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < ATT_QPW; ++kk) {
        const int kj = warp * ATT_QPW + kk;
        float pc = 0.f, ds = 0.f;
        if (i0 + lane < N && j0 + kj < N) {
          const float p = expf(fminf(dot_rows(qt + lane * Dp, kb + kj * D, D), 80.f)) / lt[lane];
          const float dp = dot_rows(dot_ + lane * Dp, vb + kj * D, D);
          pc = p;
          ds = p * (dp - dt[lane]);
        }
        pcs[kj * ATT_KT + lane] = pc;
        dss[kj * ATT_KT + lane] = ds;
      }
      __syncwarp();
      for (int i = 0; i < ATT_KT; ++i) {
#pragma unroll
        for (int c = 0; c < ATT_DC / 32; ++c) {
          if (32 * c >= dcn) break;
          const int d = dc0 + lane + 32 * c;
          const bool in = lane + 32 * c < dcn;
          const float dov = in ? dot_[i * Dp + d] : 0.f;
          const float qv = in ? qt[i * Dp + d] : 0.f;
#pragma unroll
          for (int kk = 0; kk < ATT_QPW; ++kk) {
            const int kj = warp * ATT_QPW + kk;
            av[kk][c] = fmaf(pcs[kj * ATT_KT + i], dov, av[kk][c]);
            ak[kk][c] = fmaf(dss[kj * ATT_KT + i], qv, ak[kk][c]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int kk = 0; kk < ATT_QPW; ++kk) {
      const int n = j0 + warp * ATT_QPW + kk;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < ATT_DC / 32; ++c) {
        const int d = lane + 32 * c;
        if (d >= dcn) continue;
        const size_t o = ((size_t)b * N + n) * rs + h * D + dc0 + d;
        dqkv[o + C] = ak[kk][c];
        dqkv_c[o + C] = ak[kk][c];
        dqkv[o + 2 * C] = av[kk][c];
        dqkv_c[o + 2 * C] = av[kk][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 attention backward on the tensor cores (tc_tiles.cuh's building
// blocks). Both kernels take 64-row tiles, 4 warps of 16 rows, and the saved
// row sums l; the rows the block sweeps (keys on the query side, queries on
// the key side) sit whole in shared memory where they fit (`resident`) and
// stream through it 64 at a time where they do not. DMAX output columns are
// computed at a time (the scores recomputed for each chunk of columns); KD
// as in tc::mma_abt.
//
// Query side, one block per (64 queries, head, image): pass 1 over key
// chunks of 64: S = Q K^T, dP = dO V^T, p = exp(min(S, 80)) / l unrounded,
// delta += rowsum(p * dP); pass 2: S and dP again, dS = p (dP - delta)
// rounded to bf16, dQ += dS K. Writes dq (f32 and bf16) and delta.
// ---------------------------------------------------------------------------
constexpr int BWD_CHUNK = 64;

// shared memory of the two kernels where the swept rows take `rows` rows
__host__ __device__ inline size_t attn_bwd_q_smem_tc(int rows, int D) {
  return (size_t)(2 * tc::ATT_ROWS + 2 * rows) * tc::att_pitch(D) * 2;
}

__host__ __device__ inline size_t attn_bwd_kv_smem_tc(int rows, int D) {
  return attn_bwd_q_smem_tc(rows, D) + (size_t)3 * rows * sizeof(float);
}

template <int DMAX, int KD>
__global__ void __launch_bounds__(tc::ATT_THREADS)
attn_bwd_q_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO, const float* __restrict__ lsum,
                     float* __restrict__ dqkv, bf16* __restrict__ dqkv_c, float* __restrict__ delta, int N,
                     int C, int H, int D, int resident) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int NJ = BWD_CHUNK / 16;
  const int DP = tc::round16(D), P = tc::att_pitch(D), NP = tc::round16(N);
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + tc::ATT_ROWS * P;
  bf16* ks = dos + tc::ATT_ROWS * P;
  bf16* vs = ks + (resident ? NP : BWD_CHUNK) * P;
  const int q0 = blockIdx.x * tc::ATT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * rs;
  const bf16* dbase = dO + (size_t)b * N * C;
  const int kc = C + h * D, vc = 2 * C + h * D;

  tc::load_head_rows(qs, P, base, rs, h * D, q0, tc::ATT_ROWS, N, D, tid);
  tc::load_head_rows(dos, P, dbase, (size_t)C, h * D, q0, tc::ATT_ROWS, N, D, tid);
  if (resident) {
    tc::load_head_rows(ks, P, base, rs, kc, 0, NP, N, D, tid);
    tc::load_head_rows(vs, P, base, rs, vc, 0, NP, N, D, tid);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // where keys [c0, c0 + BWD_CHUNK) sit in ks and vs: resident, or copied in now
  auto chunk = [&](int c0) {
    if (resident) return c0 * P;
    __syncthreads();  // every warp is done with the previous chunk
    tc::load_head_rows(ks, P, base, rs, kc, c0, BWD_CHUNK, N, D, tid);
    tc::load_head_rows(vs, P, base, rs, vc, c0, BWD_CHUNK, N, D, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    return 0;
  };

  const int r = q0 + warp * 16 + (lane >> 2);  // this thread's rows: r and r + 8
  const float l0 = r < N ? lsum[((size_t)b * N + r) * H + h] : 1.f;
  const float l1 = r + 8 < N ? lsum[((size_t)b * N + r + 8) * H + h] : 1.f;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const bf16* qw = qs + warp * 16 * P;
  const bf16* dw = dos + warp * 16 * P;
  float s[2 * NJ][4], dp[2 * NJ][4];

  // s <- p (unrounded), dp <- dO . v for the keys [c0, c0 + BWD_CHUNK) at ko
  auto tiles = [&](int ko, int c0) {
    tc::zero(s);
    tc::zero(dp);
    tc::mma_abt<NJ, KD>(s, qw, ks + ko, P, DP, N - c0, lane);
    tc::mma_abt<NJ, KD>(dp, dw, vs + ko, P, DP, N - c0, lane);
    tc::exp_clamp_mask(s, c0, N, lane);
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) {
      s[j][0] = tc::div_by(s[j][0], l0, inv0);
      s[j][1] = tc::div_by(s[j][1], l0, inv0);
      s[j][2] = tc::div_by(s[j][2], l1, inv1);
      s[j][3] = tc::div_by(s[j][3], l1, inv1);
    }
  };

  float d0 = 0.f, d1 = 0.f;
  for (int c0 = 0; c0 < N; c0 += BWD_CHUNK) {
    tiles(chunk(c0), c0);
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) {
      d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
      d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
    }
  }
  d0 = tc::quad_sum(d0);
  d1 = tc::quad_sum(d1);

  const size_t o = (size_t)b * N * rs + h * D;
  float dq[DMAX / 8][4];
  for (int dc0 = 0; dc0 < D; dc0 += DMAX) {
    tc::zero(dq);
    for (int c0 = 0; c0 < N; c0 += BWD_CHUNK) {
      const int ko = chunk(c0);
      tiles(ko, c0);
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j) {  // dp <- ds (rounded to bf16 by mma_ab)
        dp[j][0] = s[j][0] * (dp[j][0] - d0);
        dp[j][1] = s[j][1] * (dp[j][1] - d0);
        dp[j][2] = s[j][2] * (dp[j][2] - d1);
        dp[j][3] = s[j][3] * (dp[j][3] - d1);
      }
      tc::mma_ab<NJ, DMAX>(dq, dp, ks + ko + dc0, P, DP - dc0, N - c0, lane);
    }
    tc::store_rows(dqkv + o + dc0, rs, dq, r, N, D - dc0, lane);
    tc::store_rows(dqkv_c + o + dc0, rs, dq, r, N, D - dc0, lane);
  }
  if ((lane & 3) == 0) {
    if (r < N) delta[((size_t)b * N + r) * H + h] = d0;
    if (r + 8 < N) delta[((size_t)b * N + r + 8) * H + h] = d1;
  }
}

// Key side, one block per (64 keys, head, image), one pass over query chunks
// of 64 (for each chunk of DMAX output columns): S^T = K Q^T, dP^T = V dO^T,
// p = exp(min(S, 80)) / l_i, pc = p and dS = p (dP - delta_i), both rounded
// to bf16; dV += pc^T dO and dK += dS^T Q. Writes dk and dv (f32 and bf16).
template <int DMAX, int KD>
__global__ void __launch_bounds__(tc::ATT_THREADS)
attn_bwd_kv_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO, const float* __restrict__ lsum,
                      const float* __restrict__ delta, float* __restrict__ dqkv, bf16* __restrict__ dqkv_c,
                      int N, int C, int H, int D, int resident) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int NJ = BWD_CHUNK / 16;
  const int DP = tc::round16(D), P = tc::att_pitch(D), NP = tc::round16(N);
  const int R = resident ? NP : BWD_CHUNK;  // query rows in shared memory
  bf16* kt = reinterpret_cast<bf16*>(tc_smem);
  bf16* vt = kt + tc::ATT_ROWS * P;
  bf16* qa = vt + tc::ATT_ROWS * P;
  bf16* da = qa + R * P;
  float* lt = reinterpret_cast<float*>(da + R * P);
  float* li = lt + R;  // 1 / l
  float* dt = li + R;
  const int j0 = blockIdx.x * tc::ATT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * rs;
  const bf16* dbase = dO + (size_t)b * N * C;

  // queries [c0, c0 + rows) into qa, da, lt (l), li (1 / l), dt (delta)
  auto load_queries = [&](int c0, int rows) {
    tc::load_head_rows(qa, P, base, rs, h * D, c0, rows, N, D, tid);
    tc::load_head_rows(da, P, dbase, (size_t)C, h * D, c0, rows, N, D, tid);
    tc::cp_async_commit();
    for (int i = tid; i < rows; i += tc::ATT_THREADS) {
      const int q = c0 + i;
      lt[i] = q < N ? lsum[((size_t)b * N + q) * H + h] : 1.f;
      li[i] = 1.f / lt[i];
      dt[i] = q < N ? delta[((size_t)b * N + q) * H + h] : 0.f;
    }
    tc::cp_async_wait<0>();
  };
  tc::load_head_rows(kt, P, base, rs, C + h * D, j0, tc::ATT_ROWS, N, D, tid);
  tc::load_head_rows(vt, P, base, rs, 2 * C + h * D, j0, tc::ATT_ROWS, N, D, tid);
  if (resident) {
    load_queries(0, NP);
  } else {
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  __syncthreads();

  // the first row of queries [c0, c0 + BWD_CHUNK) in qa, da, lt, li, dt:
  // resident, or copied in now
  auto chunk = [&](int c0) {
    if (resident) return c0;
    __syncthreads();  // every warp is done with the previous chunk
    load_queries(c0, BWD_CHUNK);
    __syncthreads();
    return 0;
  };

  const bf16* kw = kt + warp * 16 * P;
  const bf16* vw = vt + warp * 16 * P;
  const int t = lane & 3;
  const int r = j0 + warp * 16 + (lane >> 2);
  const size_t o = (size_t)b * N * rs + h * D;
  float s[2 * NJ][4], dp[2 * NJ][4];
  float dk[DMAX / 8][4], dv[DMAX / 8][4];

  for (int dc0 = 0; dc0 < D; dc0 += DMAX) {
    tc::zero(dk);
    tc::zero(dv);
    for (int c0 = 0; c0 < N; c0 += BWD_CHUNK) {
      const int ro = chunk(c0);
      tc::zero(s);
      tc::zero(dp);
      tc::mma_abt<NJ, KD>(s, kw, qa + ro * P, P, DP, N - c0, lane);   // S^T: keys x queries
      tc::mma_abt<NJ, KD>(dp, vw, da + ro * P, P, DP, N - c0, lane);  // dP^T
      tc::exp_clamp_mask(s, c0, N, lane);
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);  // the query, from c0
          const bool in = c0 + qi < N;
          const float p = in ? tc::div_by(s[j][e], lt[ro + qi], li[ro + qi]) : 0.f;
          dp[j][e] = in ? p * (dp[j][e] - dt[ro + qi]) : 0.f;  // ds, rounded by mma_ab
          s[j][e] = p;                                          // pc, rounded by mma_ab
        }
      tc::mma_ab<NJ, DMAX>(dv, s, da + ro * P + dc0, P, DP - dc0, N - c0, lane);
      tc::mma_ab<NJ, DMAX>(dk, dp, qa + ro * P + dc0, P, DP - dc0, N - c0, lane);
    }
    tc::store_rows(dqkv + o + C + dc0, rs, dk, r, N, D - dc0, lane);
    tc::store_rows(dqkv_c + o + C + dc0, rs, dk, r, N, D - dc0, lane);
    tc::store_rows(dqkv + o + 2 * C + dc0, rs, dv, r, N, D - dc0, lane);
    tc::store_rows(dqkv_c + o + 2 * C + dc0, rs, dv, r, N, D - dc0, lane);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
#define CHECK_LAUNCH()                        \
  do {                                        \
    cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

#define RETURN_IF(x)    \
  do {                  \
    int e_ = (x);       \
    if (e_) return e_;  \
  } while (0)

// f32: the FMA GEMM; splits > 1 cuts K into chunks (only the f32 epilogue)
template <bool TA, bool TB, int EPI>
int gemm(const float* A, const float* B, const EpiArgs& e, int M, int N, int K, int k_chunk, int splits,
         cudaStream_t s) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, splits);
  gemm_f32_kernel<TA, TB, EPI><<<grid, GTHREADS, 0, s>>>(A, B, e, M, N, K, k_chunk);
  CHECK_LAUNCH();
  return 0;
}

// bf16: the tensor-core GEMM; a split product (weight gradients, TN) takes
// the 128x128 tile, a whole one the tile its grid calls for
template <bool TA, bool TB, int EPI>
int gemm(const bf16* A, const bf16* B, const EpiArgs& e, int M, int N, int K, int k_chunk, int splits,
         cudaStream_t s) {
  constexpr int L = TA ? tc::TN : TB ? tc::NT : tc::NN;
  const TcEpilogue<EPI> epi{e, M, N};
  if (splits > 1) return (int)tc::gemm_launch<tc::GemmBig<L>>(A, B, epi, M, N, K, k_chunk, splits, s);
  return (int)tc::gemm<L>(A, B, epi, M, N, K, s);
}

// Splits of T for a weight gradient of M x N: enough blocks for two waves
// on 132 SMs (64x64 tiles in f32, 128x128 in bf16), at least 512 rows a
// split.
template <typename T>
int grad_splits(int M, int N, int K) {
  const int tm = sizeof(T) == 4 ? GBM : 128, tn = sizeof(T) == 4 ? GBN : 128;
  const int tiles = ((M + tm - 1) / tm) * ((N + tn - 1) / tn);
  int s = (2 * tc::kSMs + tiles - 1) / tiles;
  s = std::min(s, std::max(1, K / 512));
  return std::max(1, std::min(s, 16));
}

// rows of K a split takes: a multiple of both GEMMs' k slices (16, 32)
int split_chunk(int K, int splits) { return ((K + splits - 1) / splits + 31) / 32 * 32; }

int sum_partials(const float* part, float* out, size_t n, int splits, cudaStream_t s) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  sum_partials_kernel<<<blocks, 256, 0, s>>>(part, out, n, splits);
  CHECK_LAUNCH();
  return 0;
}

// dW (M x N, f32) = A^T @ B with A stored (K, M) and B stored (K, N)
template <typename T>
int weight_grad(const T* A, const T* B, float* out, float* part, int M, int N, int K, cudaStream_t s) {
  const int splits = grad_splits<T>(M, N, K);
  const int k_chunk = split_chunk(K, splits);
  const int nz = (K + k_chunk - 1) / k_chunk;
  EpiArgs e{};
  e.out = nz > 1 ? part : out;
  RETURN_IF((gemm<true, false, EPI_F32>(A, B, e, M, N, K, k_chunk, nz, s)));
  if (nz == 1) return 0;
  return sum_partials(part, out, (size_t)M * N, nz, s);
}

int colsum_chunks(int M) { return (M + CS_ROWS - 1) / CS_ROWS; }

template <typename Tin>
int colsum(const Tin* a, const float* mask, int tokens, float* out, float* part, int M, int C,
           cudaStream_t s) {
  const dim3 grid((C + 31) / 32, colsum_chunks(M));
  colsum_kernel<Tin><<<grid, 256, 0, s>>>(a, mask, tokens, part, M, C);
  CHECK_LAUNCH();
  return sum_partials(part, out, (size_t)C, colsum_chunks(M), s);
}

template <typename Tin, typename T>
int mask_cast(const Tin* in, const float* mask, T* out, int M, int C, int tokens, cudaStream_t s) {
  const size_t n = (size_t)M * C;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 8192);
  mask_cast_kernel<Tin, T><<<blocks, 256, 0, s>>>(in, mask, out, n, C, tokens);
  CHECK_LAUNCH();
  return 0;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The attention forward: out, and the row sums l that the backward reads
int attention(const float* qkv, float* out, float* lsum, int B, int N, int C, int H, cudaStream_t s) {
  const int D = C / H;
  const size_t smem = attention_smem_bytes(D);
  RETURN_IF(set_smem(attention_f32_kernel, smem));
  attention_f32_kernel<<<dim3((N + ATT_QT - 1) / ATT_QT, H, B), ATT_THREADS, smem, s>>>(qkv, out, lsum, N, C, H, D);
  CHECK_LAUNCH();
  return 0;
}

int attention(const bf16* qkv, bf16* out, float* lsum, int B, int N, int C, int H, cudaStream_t s) {
  return (int)tc::attention_fwd(qkv, out, lsum, B, N, C, H, s);
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The backward's scratch, carved from one workspace.
template <typename T>
struct Work {
  T* dbr_c;      // M x C: the masked branch gradient, rounded to T
  float* dhpre;  // M x F
  T* dhpre_c;    // M x F
  float* dxn;    // M x C
  float* dx1;    // M x C
  float* prod;   // M x C
  T* dO;         // M x C
  float* dqkv;   // M x 3C
  T* dqkv_c;     // M x 3C
  float* delta;  // M x H
  float* part;   // partial sums
};

template <typename T>
size_t partial_floats(int M, int C, int F) {
  size_t n = (size_t)colsum_chunks(M) * std::max(3 * C, F);
  const int shapes[4][2] = {{F, C}, {C, F}, {C, C}, {C, 3 * C}};
  for (const auto& sh : shapes) {
    const int splits = grad_splits<T>(sh[0], sh[1], M);
    n = std::max(n, (size_t)splits * sh[0] * sh[1]);
  }
  return n;
}

template <typename T>
size_t carve(Work<T>* w, char* base, int M, int C, int H, int F) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t mc = (size_t)M * C;
  w->dbr_c = (T*)take(mc * sizeof(T));
  w->dhpre = (float*)take((size_t)M * F * 4);
  w->dhpre_c = (T*)take((size_t)M * F * sizeof(T));
  w->dxn = (float*)take(mc * 4);
  w->dx1 = (float*)take(mc * 4);
  w->prod = (float*)take(mc * 4);
  w->dO = (T*)take(mc * sizeof(T));
  w->dqkv = (float*)take(3 * mc * 4);
  w->dqkv_c = (T*)take(3 * mc * sizeof(T));
  w->delta = (float*)take((size_t)M * H * 4);
  w->part = (float*)take(partial_floats<T>(M, C, F) * 4);
  return off;
}

// The attention backward: dq, dk, dv (f32 and T) into w.dqkv, w.dqkv_c
int attention_backward(const float* qkv, const float* lsum, Work<float>& w, int B, int N, int C, int H,
                       cudaStream_t s) {
  const int D = C / H;
  const dim3 grid((N + ATT_QT - 1) / ATT_QT, H, B);
  const size_t smem_q = attn_bwd_q_smem_bytes(D);
  RETURN_IF(set_smem(attn_bwd_q_f32_kernel, smem_q));
  attn_bwd_q_f32_kernel<<<grid, ATT_THREADS, smem_q, s>>>(qkv, w.dO, lsum, w.dqkv, w.dqkv_c, w.delta, N, C, H, D);
  CHECK_LAUNCH();
  const size_t smem_kv = attn_bwd_kv_smem_bytes(D);
  RETURN_IF(set_smem(attn_bwd_kv_f32_kernel, smem_kv));
  attn_bwd_kv_f32_kernel<<<grid, ATT_THREADS, smem_kv, s>>>(qkv, w.dO, lsum, w.delta, w.dqkv, w.dqkv_c, N, C, H, D);
  CHECK_LAUNCH();
  return 0;
}

template <int DMAX, int KD>
int attention_backward_tc(const bf16* qkv, const float* lsum, Work<bf16>& w, int B, int N, int C, int H,
                          cudaStream_t s) {
  const int D = C / H, NP = tc::round16(N);
  const dim3 grid((N + tc::ATT_ROWS - 1) / tc::ATT_ROWS, H, B);
  const int res_q = attn_bwd_q_smem_tc(NP, D) <= tc::kSmemMax;
  const size_t smem_q = attn_bwd_q_smem_tc(res_q ? NP : BWD_CHUNK, D);
  RETURN_IF((int)cudaFuncSetAttribute(attn_bwd_q_tc_kernel<DMAX, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem_q));
  attn_bwd_q_tc_kernel<DMAX, KD><<<grid, tc::ATT_THREADS, smem_q, s>>>(qkv, w.dO, lsum, w.dqkv, w.dqkv_c, w.delta,
                                                                       N, C, H, D, res_q);
  CHECK_LAUNCH();
  const int res_kv = attn_bwd_kv_smem_tc(NP, D) <= tc::kSmemMax;
  const size_t smem_kv = attn_bwd_kv_smem_tc(res_kv ? NP : BWD_CHUNK, D);
  RETURN_IF((int)cudaFuncSetAttribute(attn_bwd_kv_tc_kernel<DMAX, KD>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv));
  attn_bwd_kv_tc_kernel<DMAX, KD><<<grid, tc::ATT_THREADS, smem_kv, s>>>(qkv, w.dO, lsum, w.delta, w.dqkv,
                                                                         w.dqkv_c, N, C, H, D, res_kv);
  CHECK_LAUNCH();
  return 0;
}

// heads up to 64 wide: one chunk of output columns, the loop over the head
// width unrolled; wider heads: 64 columns at a time, the loop not unrolled
int attention_backward(const bf16* qkv, const float* lsum, Work<bf16>& w, int B, int N, int C, int H,
                       cudaStream_t s) {
  if (tc::round16(C / H) <= 64) return attention_backward_tc<64, 64>(qkv, lsum, w, B, N, C, H, s);
  return attention_backward_tc<64, 0>(qkv, lsum, w, B, N, C, H, s);
}

template <typename T>
int run_forward(const T* x, const float* m1, const float* m2, const float* ln1_s,
                const float* ln1_b, const T* w_qkv, const float* b_qkv, const T* w_proj,
                const float* b_proj, const float* ln2_s, const float* ln2_b, const T* w_fc1,
                const float* b_fc1, const T* w_fc2, const float* b_fc2, T* xn1, T* qkv, T* attn,
                float* x1, T* xn2, float* hpre, T* hidden, float* lsum, T* out, int B, int N, int C,
                int H, int F, float eps, cudaStream_t s) {
  const int M = B * N;
  const dim3 ln_grid((M + LN_WARPS - 1) / LN_WARPS);

  layernorm_kernel<T, T><<<ln_grid, LN_WARPS * 32, 0, s>>>(x, ln1_s, ln1_b, xn1, M, C, eps);
  CHECK_LAUNCH();
  EpiArgs e{};
  e.bias = b_qkv;
  e.out = qkv;
  RETURN_IF((gemm<false, false, EPI_QKV>(xn1, w_qkv, e, M, 3 * C, C, C, 1, s)));
  RETURN_IF(attention(qkv, attn, lsum, B, N, C, H, s));

  e = EpiArgs{};
  e.bias = b_proj;
  e.mask = m1;
  e.tokens = N;
  e.res = x;
  e.out = x1;
  RETURN_IF((gemm<false, false, EPI_PROJ>(attn, w_proj, e, M, C, C, C, 1, s)));
  layernorm_kernel<float, T><<<ln_grid, LN_WARPS * 32, 0, s>>>(x1, ln2_s, ln2_b, xn2, M, C, eps);
  CHECK_LAUNCH();
  e = EpiArgs{};
  e.bias = b_fc1;
  e.out = hpre;
  e.out2 = hidden;
  RETURN_IF((gemm<false, false, EPI_FC1>(xn2, w_fc1, e, M, F, C, C, 1, s)));
  e = EpiArgs{};
  e.bias = b_fc2;
  e.mask = m2;
  e.tokens = N;
  e.res = x1;
  e.out = out;
  RETURN_IF((gemm<false, false, EPI_FC2>(hidden, w_fc2, e, M, C, F, F, 1, s)));
  return 0;
}

template <typename T>
int run_backward(const T* g, const T* x, const float* m1, const float* m2, const float* ln1_s,
                 const T* w_qkv, const T* w_proj, const float* ln2_s, const T* w_fc1,
                 const T* w_fc2, const T* xn1, const T* qkv, const T* attn, const float* x1,
                 const T* xn2, const float* hpre, const T* hidden, const float* lsum, T* dx,
                 float* dl1s, float* dl1b, float* dwqkv, float* dbqkv, float* dwp, float* dbp,
                 float* dl2s, float* dl2b, float* dw1, float* db1, float* dw2, float* db2, void* work,
                 int B, int N, int C, int H, int F, float eps, cudaStream_t s) {
  const int M = B * N;
  Work<T> w;
  carve(&w, static_cast<char*>(work), M, C, H, F);
  const dim3 ln_grid((M + LN_WARPS - 1) / LN_WARPS);

  // ---- MLP / LN2 half: (x1, g) -> dx1 and the W1, b1, W2, b2, LN2 grads
  RETURN_IF(mask_cast(g, m2, w.dbr_c, M, C, N, s));
  RETURN_IF(colsum(g, m2, N, db2, w.part, M, C, s));
  RETURN_IF(weight_grad(hidden, w.dbr_c, dw2, w.part, F, C, M, s));
  EpiArgs e{};
  e.res = hpre;
  e.out = w.dhpre;
  e.out2 = w.dhpre_c;
  RETURN_IF((gemm<false, true, EPI_DH>(w.dbr_c, w_fc2, e, M, F, C, C, 1, s)));
  RETURN_IF(colsum(w.dhpre, (const float*)nullptr, N, db1, w.part, M, F, s));
  RETURN_IF(weight_grad(xn2, w.dhpre_c, dw1, w.part, C, F, M, s));
  e = EpiArgs{};
  e.out = w.dxn;
  RETURN_IF((gemm<false, true, EPI_F32>(w.dhpre_c, w_fc1, e, M, C, F, F, 1, s)));
  layernorm_backward_kernel<float, T, float><<<ln_grid, LN_WARPS * 32, 0, s>>>(
      x1, w.dxn, ln2_s, g, w.dx1, w.prod, M, C, eps);
  CHECK_LAUNCH();
  RETURN_IF(colsum(w.prod, (const float*)nullptr, N, dl2s, w.part, M, C, s));
  RETURN_IF(colsum(w.dxn, (const float*)nullptr, N, dl2b, w.part, M, C, s));

  // ---- attention / LN1 half: (x, dx1) -> dx and the Wqkv, bqkv, Wp, bp, LN1 grads
  RETURN_IF(mask_cast(w.dx1, m1, w.dbr_c, M, C, N, s));
  RETURN_IF(colsum(w.dx1, m1, N, dbp, w.part, M, C, s));
  e = EpiArgs{};
  e.out = w.dO;
  RETURN_IF((gemm<false, true, EPI_CAST>(w.dbr_c, w_proj, e, M, C, C, C, 1, s)));
  RETURN_IF(weight_grad(attn, w.dbr_c, dwp, w.part, C, C, M, s));
  RETURN_IF(attention_backward(qkv, lsum, w, B, N, C, H, s));

  RETURN_IF(colsum(w.dqkv, (const float*)nullptr, N, dbqkv, w.part, M, 3 * C, s));
  RETURN_IF(weight_grad(xn1, w.dqkv_c, dwqkv, w.part, C, 3 * C, M, s));
  e = EpiArgs{};
  e.out = w.dxn;
  RETURN_IF((gemm<false, true, EPI_F32>(w.dqkv_c, w_qkv, e, M, C, 3 * C, 3 * C, 1, s)));
  layernorm_backward_kernel<T, float, T><<<ln_grid, LN_WARPS * 32, 0, s>>>(
      x, w.dxn, ln1_s, w.dx1, dx, w.prod, M, C, eps);
  CHECK_LAUNCH();
  RETURN_IF(colsum(w.prod, (const float*)nullptr, N, dl1s, w.part, M, C, s));
  RETURN_IF(colsum(w.dxn, (const float*)nullptr, N, dl1b, w.part, M, C, s));
  return 0;
}

}  // namespace

extern "C" {

// Why the layer (forward and backward) cannot run with heads D wide, or
// NULL. dtype as below.
const char* vit_layer_train_shape_error(int dtype, int D) {
  if (dtype == 0) {
    const size_t smem = std::max({attention_smem_bytes(D), attn_bwd_q_smem_bytes(D), attn_bwd_kv_smem_bytes(D)});
    return smem > tc::kSmemMax ? "f32: the head width exceeds one block's shared memory" : nullptr;
  }
  return tc::bf16_shape_error(D, attn_bwd_kv_smem_tc(BWD_CHUNK, D));
}

const char* vit_layer_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Bytes of the backward's workspace, written to *bytes (int64).
int vit_layer_train_workspace_bytes(int dtype, int B, int N, int C, int H, int F, void* bytes) {
  const int M = B * N;
  size_t n;
  if (dtype == 0) {
    Work<float> w;
    n = carve(&w, nullptr, M, C, H, F);
  } else {
    Work<bf16> w;
    n = carve(&w, nullptr, M, C, H, F);
  }
  *static_cast<int64_t*>(bytes) = (int64_t)n;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, the four weights, xn1, qkv, attn, xn2,
// hidden, out). Masks, norms, biases, x1, hpre and lsum (the softmax row
// sums, (B*N, H)) are float32. The caller checks
// vit_layer_train_shape_error first. Returns 0 or the first CUDA error code.
int vit_layer_train_forward(int dtype, const void* x, const void* m1, const void* m2,
                            const void* ln1_s, const void* ln1_b, const void* w_qkv,
                            const void* b_qkv, const void* w_proj, const void* b_proj,
                            const void* ln2_s, const void* ln2_b, const void* w_fc1,
                            const void* b_fc1, const void* w_fc2, const void* b_fc2, void* xn1,
                            void* qkv, void* attn, void* x1, void* xn2, void* hpre, void* hidden,
                            void* lsum, void* out, int B, int N, int C, int H, int F, float eps,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32(p) static_cast<const float*>(p)
#define RUN_FWD(T)                                                                              \
  run_forward<T>(static_cast<const T*>(x), F32(m1), F32(m2), F32(ln1_s), F32(ln1_b),            \
                 static_cast<const T*>(w_qkv), F32(b_qkv), static_cast<const T*>(w_proj),       \
                 F32(b_proj), F32(ln2_s), F32(ln2_b), static_cast<const T*>(w_fc1), F32(b_fc1), \
                 static_cast<const T*>(w_fc2), F32(b_fc2), static_cast<T*>(xn1),                \
                 static_cast<T*>(qkv), static_cast<T*>(attn), static_cast<float*>(x1),          \
                 static_cast<T*>(xn2), static_cast<float*>(hpre), static_cast<T*>(hidden),      \
                 static_cast<float*>(lsum), static_cast<T*>(out), B, N, C, H, F, eps, s)
  if (dtype == 0) return RUN_FWD(float);
  return RUN_FWD(bf16);
#undef RUN_FWD
}

// g: the gradient of out (T). Outputs dx (T) and the twelve parameter
// gradients (f32) of the layer as the forward received them (W_qkv, b_qkv
// with the q-scale folded in). work: vit_layer_train_workspace_bytes bytes.
int vit_layer_train_backward(int dtype, const void* g, const void* x, const void* m1,
                             const void* m2, const void* ln1_s, const void* w_qkv,
                             const void* w_proj, const void* ln2_s, const void* w_fc1,
                             const void* w_fc2, const void* xn1, const void* qkv,
                             const void* attn, const void* x1, const void* xn2, const void* hpre,
                             const void* hidden, const void* lsum, void* dx, void* dl1s, void* dl1b,
                             void* dwqkv, void* dbqkv, void* dwp, void* dbp, void* dl2s, void* dl2b,
                             void* dw1, void* db1, void* dw2, void* db2, void* work, int B, int N,
                             int C, int H, int F, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define O32(p) static_cast<float*>(p)
#define RUN_BWD(T)                                                                                \
  run_backward<T>(static_cast<const T*>(g), static_cast<const T*>(x), F32(m1), F32(m2),           \
                  F32(ln1_s), static_cast<const T*>(w_qkv), static_cast<const T*>(w_proj),        \
                  F32(ln2_s), static_cast<const T*>(w_fc1), static_cast<const T*>(w_fc2),         \
                  static_cast<const T*>(xn1), static_cast<const T*>(qkv),                         \
                  static_cast<const T*>(attn), F32(x1), static_cast<const T*>(xn2), F32(hpre),    \
                  static_cast<const T*>(hidden), F32(lsum), static_cast<T*>(dx), O32(dl1s),       \
                  O32(dl1b), O32(dwqkv), O32(dbqkv), O32(dwp), O32(dbp), O32(dl2s), O32(dl2b),    \
                  O32(dw1), O32(db1), O32(dw2), O32(db2), work, B, N, C, H, F, eps, s)
  if (dtype == 0) return RUN_BWD(float);
  return RUN_BWD(bf16);
#undef RUN_BWD
#undef O32
#undef F32
}

}  // extern "C"
