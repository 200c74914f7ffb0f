// BatchNorm in training mode with flax's semantics, forward and backward, as
// hand-written CUDA for Hopper (sm_90a), f32:
//   mean_c = E[x],  var_c = max(E[x^2] - mean_c^2, 0),  inv_c = rsqrt(var_c + eps),
//   y = (x - mean_c) inv_c w_c + b_c,
// the expectations over the batch and the map (B H W elements a channel), and
// the running statistics updated with the biased variance:
//   running = (1 - momentum) running + momentum stat.
// The backward is the usual one, x^ = (x - mean) inv:
//   dx = inv w (dy - sum(dy) / N - x^ sum(dy x^) / N),  dw = sum(dy x^),  db = sum(dy).
// (A channel whose E[x^2] - mean^2 rounds below 0, a constant one, takes the
// variance's gradient too, where the plain twin's clamp passes none; its x^ is
// 0 there up to rounding.)
//
// It replaces no TPU kernel: the JAX package's BatchNorm (flax.linen.BatchNorm,
// probpose_code_tpu/models/backbones/resnet.py:_bn) is XLA's. In PyTorch
// (models/heads/heatmap_head.py:BatchNorm2d, the plain twin) the forward takes
// five passes over the map (two means, a subtraction, a product, a sum) and
// autograd's backward about eight; on the card BatchNorm took 43% of
// LiteHRNet-18's B = 64 training step and 17% of HRFormer-small's (the 2%
// rule, PERF.md section 6). Here the forward is three launches (the channel
// sums, their finish with the running statistics, the normalisation) and the
// backward three (the sums of dy and dy (x - mean), their finish with dw and db,
// dx): two passes over the map forward and two backward (three maps read,
// one written).
//
// The map is NCHW (B, C, P) with P = H W, or channels last (R, C) with R =
// B H W. bn_reduce_* write each block's partial sums of u and u (v - m_c) (u u
// without v); bn_finish_* add the partials of a channel, a warp a channel, in a
// fixed order (the sums are deterministic) and compute the per-channel
// coefficients; bn_apply
// writes out = A_c (u - M_c) + B_c (v - M_c) + D_c, the B term only where v is
// given. Memory-bound: the bound is 8 bytes an element forward (x read, y
// written) and 12 backward (dy and x read, dx written); this design reads x
// twice forward and dy and x twice backward.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 32;  // channels-last: a block's channels
constexpr int ROWS = 8;   // channels-last: a block's row lanes

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NCHW: a block a (channel, chunk of `per` samples): grid (C, S).
__global__ void bn_reduce_nchw_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                      const float* __restrict__ m, float* __restrict__ partial, int B, int C, int P,
                                      int per) {
  const int c = blockIdx.x, s = blockIdx.y;
  const int b0 = s * per, n = (min(B, b0 + per) - b0) * P;
  const float mc = v ? __ldg(m + c) : 0.f;
  float a1 = 0.f, a2 = 0.f;
  if (P >= THREADS) {  // a plane at a time
    for (int b = b0; b < b0 + n / P; ++b) {
      const long long base = ((long long)b * C + c) * P;
      for (int p = threadIdx.x; p < P; p += THREADS) {
        const float x = __ldg(u + base + p);
        a1 += x;
        a2 += x * (v ? __ldg(v + base + p) - mc : x);
      }
    }
  } else {  // the chunk's (sample, position) pairs flattened: small planes keep every thread busy
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const long long at = ((long long)(b0 + i / P) * C + c) * P + i % P;
      const float x = __ldg(u + at);
      a1 += x;
      a2 += x * (v ? __ldg(v + at) - mc : x);
    }
  }
  __shared__ float sh[2][THREADS / 32];
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (threadIdx.x % 32 == 0) {
    sh[0][threadIdx.x / 32] = a1;
    sh[1][threadIdx.x / 32] = a2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      t1 += sh[0][w];
      t2 += sh[1][w];
    }
    partial[((long long)s * C + c) * 2] = t1;
    partial[((long long)s * C + c) * 2 + 1] = t2;
  }
}

// Channels last: a block a (tile of 32 channels, chunk of `per` rows): grid (ceil(C / 32), S), block (32, 8).
__global__ void bn_reduce_nhwc_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                      const float* __restrict__ m, float* __restrict__ partial, long long R, int C,
                                      long long per) {
  const int c = blockIdx.x * COLS + threadIdx.x, s = blockIdx.y;
  const long long r0 = s * per, r1 = min(R, r0 + per);
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    const float mc = v ? __ldg(m + c) : 0.f;
    for (long long r = r0 + threadIdx.y; r < r1; r += ROWS) {
      const float x = __ldg(u + r * C + c);
      a1 += x;
      a2 += x * (v ? __ldg(v + r * C + c) - mc : x);
    }
  }
  __shared__ float sh[2][ROWS][COLS];
  sh[0][threadIdx.y][threadIdx.x] = a1;
  sh[1][threadIdx.y][threadIdx.x] = a2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < ROWS; ++y) {
      t1 += sh[0][y][threadIdx.x];
      t2 += sh[1][y][threadIdx.x];
    }
    partial[((long long)s * C + c) * 2] = t1;
    partial[((long long)s * C + c) * 2 + 1] = t2;
  }
}

// The forward's finish, a thread a channel: mean, inv, the normalisation's
// coefficients (A = inv w, D = b) and the running statistics.
// A channel's partial sums added by one warp: each lane a stride of them, then the lanes by shuffles, in a
// fixed order.
__device__ __forceinline__ void channel_sums(const float* __restrict__ partial, int S, int C, int c, float* s1,
                                             float* s2) {
  float t1 = 0.f, t2 = 0.f;
  for (int s = threadIdx.x % 32; s < S; s += 32) {
    t1 += partial[((long long)s * C + c) * 2];
    t2 += partial[((long long)s * C + c) * 2 + 1];
  }
  *s1 = warp_sum(t1);
  *s2 = warp_sum(t2);
}

constexpr int FINISH_WARPS = 4;

__global__ void bn_finish_forward_kernel(const float* __restrict__ partial, int S, int C, float n,
                                         const float* __restrict__ w, const float* __restrict__ b,
                                         float* __restrict__ mean, float* __restrict__ inv, float* __restrict__ A,
                                         float* __restrict__ D, float* __restrict__ running_mean,
                                         float* __restrict__ running_var, float momentum, float eps) {
  const int c = blockIdx.x * FINISH_WARPS + threadIdx.x / 32;
  if (c >= C) return;
  float s1, s2;
  channel_sums(partial, S, C, c, &s1, &s2);
  if (threadIdx.x % 32) return;
  const float mc = s1 / n;
  const float var = fmaxf(s2 / n - mc * mc, 0.f);
  const float ic = rsqrtf(var + eps);
  mean[c] = mc;
  inv[c] = ic;
  A[c] = ic * w[c];
  D[c] = b[c];
  running_mean[c] = running_mean[c] * (1.f - momentum) + momentum * mc;
  running_var[c] = running_var[c] * (1.f - momentum) + momentum * var;
}

// The backward's finish, a thread a channel: dw, db and dx's coefficients,
// dx = A dy + B (x - mean) + D.
__global__ void bn_finish_backward_kernel(const float* __restrict__ partial, int S, int C, float n,
                                          const float* __restrict__ w, const float* __restrict__ inv,
                                          float* __restrict__ dw, float* __restrict__ db, float* __restrict__ A,
                                          float* __restrict__ Bc, float* __restrict__ D) {
  const int c = blockIdx.x * FINISH_WARPS + threadIdx.x / 32;
  if (c >= C) return;
  float sdy, sdx;
  channel_sums(partial, S, C, c, &sdy, &sdx);
  if (threadIdx.x % 32) return;
  const float ic = inv[c];
  const float shat = ic * sdx;  // sum(dy x^)
  const float a = ic * w[c];
  dw[c] = shat;
  db[c] = sdy;
  A[c] = a;
  Bc[c] = -a * ic * shat / n;
  D[c] = -a * sdy / n;
}

unsigned apply_blocks(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// out = A_c (u - M_c) + B_c (v - V_c) + D_c (M_c 0 without M; the B term only with v). The maps hold under
// 2^31 elements (the wrapper checks), so indices are 32-bit. vec: four elements a thread, 16 bytes a load
// (NCHW with P a multiple of 4: one channel; channels last with C a multiple of 4: four channels), else one.
__device__ __forceinline__ float bn_one(const float* __restrict__ M, const float* __restrict__ V,
                                        const float* __restrict__ A, const float* __restrict__ Bc,
                                        const float* __restrict__ D, float u, float v, bool has_v, int c) {
  float y = __ldg(A + c) * (u - (M ? __ldg(M + c) : 0.f)) + __ldg(D + c);
  if (has_v) y += __ldg(Bc + c) * (v - __ldg(V + c));
  return y;
}

__global__ void bn_apply_kernel(const float* __restrict__ u, const float* __restrict__ M, const float* __restrict__ v,
                                const float* __restrict__ V, const float* __restrict__ A, const float* __restrict__ Bc,
                                const float* __restrict__ D, float* __restrict__ out, unsigned n, unsigned C,
                                unsigned P, bool last, bool vec) {
  const bool has_v = v != nullptr;
  const unsigned stride = gridDim.x * THREADS;
  if (vec) {
    for (unsigned q = blockIdx.x * THREADS + threadIdx.x; q < n / 4; q += stride) {
      const unsigned i = 4 * q;
      const float4 a = __ldg(reinterpret_cast<const float4*>(u) + q);
      const float4 b = has_v ? __ldg(reinterpret_cast<const float4*>(v) + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y;
      if (last) {
        const int c = (int)(i % C);
        y.x = bn_one(M, V, A, Bc, D, a.x, b.x, has_v, c);
        y.y = bn_one(M, V, A, Bc, D, a.y, b.y, has_v, c + 1);
        y.z = bn_one(M, V, A, Bc, D, a.z, b.z, has_v, c + 2);
        y.w = bn_one(M, V, A, Bc, D, a.w, b.w, has_v, c + 3);
      } else {
        const int c = (int)((i / P) % C);
        y.x = bn_one(M, V, A, Bc, D, a.x, b.x, has_v, c);
        y.y = bn_one(M, V, A, Bc, D, a.y, b.y, has_v, c);
        y.z = bn_one(M, V, A, Bc, D, a.z, b.z, has_v, c);
        y.w = bn_one(M, V, A, Bc, D, a.w, b.w, has_v, c);
      }
      reinterpret_cast<float4*>(out)[q] = y;
    }
    return;
  }
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const int c = last ? (int)(i % C) : (int)((i / P) % C);
    out[i] = bn_one(M, V, A, Bc, D, __ldg(u + i), has_v ? __ldg(v + i) : 0.f, has_v, c);
  }
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

void apply(const float* u, const float* M, const float* v, const float* V, const float* A, const float* Bc,
           const float* D, float* out, long long n, int C, int P, bool last, cudaStream_t st) {
  const bool vec = (last ? C % 4 == 0 : P % 4 == 0) && aligned(u) && aligned(v) && aligned(out);
  bn_apply_kernel<<<apply_blocks(vec ? n / 4 : n), THREADS, 0, st>>>(u, M, v, V, A, Bc, D, out, (unsigned)n,
                                                                      (unsigned)C, (unsigned)P, last, vec);
}


// The reduce's grid: S chunks. NCHW: `per` samples a block, at least 4096 elements where the batch allows.
// Channels last: 256 rows a block.
int chunks(int B, int C, int P, bool last, long long* per) {
  if (last) {
    const long long R = (long long)B * P;
    *per = 256;
    return (int)((R + 255) / 256);
  }
  long long p = (4096 + P - 1) / P;
  if (p > B) p = B;
  *per = p;
  return (int)((B + p - 1) / p);
}

int reduce(const float* u, const float* v, const float* m, float* partial, int B, int C, int P, bool last, int S,
           long long per, cudaStream_t st) {
  if (last) {
    bn_reduce_nhwc_kernel<<<dim3((C + COLS - 1) / COLS, S), dim3(COLS, ROWS), 0, st>>>(u, v, m, partial,
                                                                                       (long long)B * P, C, per);
  } else {
    bn_reduce_nchw_kernel<<<dim3(C, S), THREADS, 0, st>>>(u, v, m, partial, B, C, P, (int)per);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* batch_norm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The number of partial sums (2 floats a channel each) the reduce of a (B, C, P) map writes.
long long batch_norm_scratch(int B, int C, int P, int last) {
  long long per;
  return (long long)chunks(B, C, P, last != 0, &per) * C * 2;
}

// y = BN(x) in training mode; writes mean and inv (C each) for the backward and updates the running statistics.
// coef: 2 C floats of scratch (A, D), partial: batch_norm_scratch floats.
int batch_norm_forward(const void* x, const void* w, const void* b, void* y, void* mean, void* inv,
                       void* running_mean, void* running_var, void* coef, void* partial, int B, int C, int P,
                       int last, float momentum, float eps, void* stream) {
  const long long n = (long long)B * C * P;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long per;
  const int S = chunks(B, C, P, last != 0, &per);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partial);
  int code = reduce(xf, nullptr, nullptr, pf, B, C, P, last != 0, S, per, st);
  if (code) return code;
  float* A = static_cast<float*>(coef);
  float* D = A + C;
  bn_finish_forward_kernel<<<(C + FINISH_WARPS - 1) / FINISH_WARPS, 32 * FINISH_WARPS, 0, st>>>(
      pf, S, C, (float)((long long)B * P), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(mean), static_cast<float*>(inv), A, D, static_cast<float*>(running_mean),
      static_cast<float*>(running_var), momentum, eps);
  code = (int)cudaGetLastError();
  if (code) return code;
  apply(xf, static_cast<const float*>(mean), nullptr, nullptr, A, nullptr, D, static_cast<float*>(y), n, C, P,
        last != 0, st);
  return (int)cudaGetLastError();
}

// dx, dw, db from dy and the forward's x, w, mean and inv (dy and x in one layout). coef: 3 C floats of scratch.
int batch_norm_backward(const void* dy, const void* x, const void* w, const void* mean, const void* inv, void* dx,
                        void* dw, void* db, void* coef, void* partial, int B, int C, int P, int last, void* stream) {
  const long long n = (long long)B * C * P;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long per;
  const int S = chunks(B, C, P, last != 0, &per);
  const float* dyf = static_cast<const float*>(dy);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  float* pf = static_cast<float*>(partial);
  int code = reduce(dyf, xf, mf, pf, B, C, P, last != 0, S, per, st);
  if (code) return code;
  float* A = static_cast<float*>(coef);
  float* Bc = A + C;
  float* D = Bc + C;
  bn_finish_backward_kernel<<<(C + FINISH_WARPS - 1) / FINISH_WARPS, 32 * FINISH_WARPS, 0, st>>>(
      pf, S, C, (float)((long long)B * P), static_cast<const float*>(w), static_cast<const float*>(inv),
      static_cast<float*>(dw), static_cast<float*>(db), A, Bc, D);
  code = (int)cudaGetLastError();
  if (code) return code;
  apply(dyf, nullptr, xf, mf, A, Bc, D, static_cast<float*>(dx), n, C, P, last != 0, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
