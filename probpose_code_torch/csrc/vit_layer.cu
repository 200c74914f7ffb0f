// One pre-norm ViT layer for serving, as hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel probpose_code_tpu/ops/pallas/vit_layer.py:
// vit_layer_fused (_layer_kernel). It computes exactly that kernel's math:
//
//   xn  = LN1(x)                       f32 statistics, var = E[x^2] - mean^2
//   qkv = xn @ W_qkv + b_qkv           the 1/sqrt(D) q-scale is folded into
//                                      W_qkv / b_qkv by the caller
//   p   = exp(min(q.k, 80)) / sum      per image and head, no max shift
//   attn= p @ v
//   x1  = x + attn @ W_proj + b_proj   kept in f32
//   out = x1 + gelu(LN2(x1) @ W1 + b1) @ W2 + b2, cast to x's type
//
// Operands are T (bf16 or f32), every product accumulates in f32, and the
// intermediates are rounded to T exactly where the TPU kernel rounds them.
//
// Why seven launches and not one: the TPU kernel keeps a group of whole
// images in VMEM. On the H100 a block has at most 227 KB of shared memory,
// and x alone is 295 KB in f32 at N = 192, C = 384 for one group of four
// images, so a whole layer cannot sit in one block. Here the intermediates
// (xn, qkv, attn, x1, hidden) round-trip through device memory.
//
// What bounds it: operations. At the flagship shape (128 images, N = 192,
// C = 384, F = 1536) a layer is 94.2 GFLOP against 41 MB of inputs and
// outputs in bf16: 95 us at 989 TFLOP/s bf16, against 12 us for the bytes
// at 3.35 TB/s. At the ViTPose-B predict shape (C = 768, F = 3072, f32) it
// is 362.4 GFLOP: 2.2 ms at the 165 TFLOP/s of f32-accurate products that
// 3xTF32 leaves of the tensor cores' 495 TF32. What the design does about
// it: every product and the attention run on the tensor cores through the
// shared tile engine (tc_tiles.cuh: mma.sync from ldmatrix fragments, a
// cp.async ring, 128x128 or 128x64 block tiles), with the epilogues (bias,
// the f32 residual, GELU) on the accumulators. bf16 operands go as they
// are; f32 operands as 3xTF32 (each split into two TF32 parts, three
// products), since the f32 bar (relative error 1e-4) rules out single-pass
// TF32's 2^-11. At the 256x192 crops' shape (N = 192; heads up to 64 wide,
// and in f32 up to 96, ViT-H's 80) the attention computes each score once
// and keeps the key row in registers, and at any shape it never writes the
// N x N scores to device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tiles.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, statistics in f32.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ y,
                 int M, int C, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const Tin* xr = x + (size_t)row * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / (float)C;
  const float var = ss / (float)C - mean * mean;
  const float sinv = rsqrtf(var + eps);
  Tout* yr = y + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    yr[c] = from_f<Tout>((to_f(xr[c]) - mean) * sinv * scale[c] + bias[c]);
  }
}

// ---------------------------------------------------------------------------
// GEMM epilogues, shared by the f32 (3xTF32) and bf16 tensor-core GEMMs:
// W outputs (m, n), (m, n + 1), ... at offset o, rounded where the TPU kernel
// rounds them.
// ---------------------------------------------------------------------------
enum Epilogue { EPI_QKV = 0, EPI_PROJ = 1, EPI_FC1 = 2, EPI_FC2 = 3 };

struct EpiArgs {
  const float* bias;
  const void* res;  // PROJ: x (T); FC2: x1 (f32)
  void* out;        // PROJ: x1 (f32); others T
  int exact_gelu;
};

__device__ __forceinline__ float gelu(float v, int exact) {
  if (exact) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

template <int W> __device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if (W == 1) p[0] = v[0]; else tc::store2(p, v[0], v[W - 1]);
}
template <int W> __device__ __forceinline__ void store_w(__nv_bfloat16* p, const float (&v)[W]) {
  if (W == 1) p[0] = __float2bfloat16(v[0]); else tc::store2(p, v[0], v[W - 1]);
}

template <typename T, int EPI, int W>
__device__ __forceinline__ void epilogue(const EpiArgs& e, int n, size_t o, const float (&v)[W]) {
  static_assert(W == 1 || W == 2, "one output or a pair");
  float r[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float b = e.bias[n + i];
    if (EPI == EPI_QKV) {
      r[i] = v[i] + b;
    } else if (EPI == EPI_PROJ) {
      r[i] = (to_f(static_cast<const T*>(e.res)[o + i]) + v[i]) + b;  // x1 = x + attn @ W_proj + b_proj
    } else if (EPI == EPI_FC1) {
      r[i] = gelu(v[i] + b, e.exact_gelu);
    } else {
      r[i] = (static_cast<const float*>(e.res)[o + i] + v[i]) + b;  // out = x1 + hidden @ W2 + b2
    }
  }
  if (EPI == EPI_PROJ) {
    store_w<W>(static_cast<float*>(e.out) + o, r);  // x1 in f32
  } else {
    store_w<W>(static_cast<T*>(e.out) + o, r);
  }
}

// The tensor-core GEMMs' epilogue: a pair of columns (n, n + 1), stored
// together where N is even; one at a time where it is odd (the pair is then
// misaligned and may end past the row).
template <typename T, int EPI>
struct TcEpilogue {
  EpiArgs e;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const size_t o = (size_t)m * N + n;
    if (N % 2 == 0) {
      const float v[2] = {v0, v1};
      epilogue<T, EPI, 2>(e, n, o, v);
      return;
    }
    const float a[1] = {v0};
    epilogue<T, EPI, 1>(e, n, o, a);
    if (n + 1 < N) {
      const float c[1] = {v1};
      epilogue<T, EPI, 1>(e, n + 1, o + 1, c);
    }
  }
};

template <int EPI>
int gemm(const float* A, const float* W, const EpiArgs& e, int M, int N, int K, cudaStream_t s) {
  return (int)tc::gemm_tf32(A, W, TcEpilogue<float, EPI>{e, N}, M, N, K, s);
}

template <int EPI>
int gemm(const __nv_bfloat16* A, const __nv_bfloat16* W, const EpiArgs& e, int M, int N, int K, cudaStream_t s) {
  return (int)tc::gemm<tc::NN>(A, W, TcEpilogue<__nv_bfloat16, EPI>{e, N}, M, N, K, s);
}

template <typename T>
int run_layer(const T* x, const float* ln1_s, const float* ln1_b, const T* w_qkv,
              const float* b_qkv, const T* w_proj, const float* b_proj,
              const float* ln2_s, const float* ln2_b, const T* w_fc1, const float* b_fc1,
              const T* w_fc2, const float* b_fc2, T* xn, T* qkv, T* attn, float* x1,
              T* hidden, T* out, int B, int N, int C, int H, int F, float eps,
              int exact_gelu, cudaStream_t stream) {
  const int M = B * N;
  int err;
#define RETURN_IF(call)          \
  do {                           \
    err = (call);                \
    if (err != 0) return err;    \
  } while (0)

  const dim3 ln_grid((M + LN_WARPS - 1) / LN_WARPS);
  const dim3 ln_block(LN_WARPS * 32);

  layernorm_kernel<T, T><<<ln_grid, ln_block, 0, stream>>>(x, ln1_s, ln1_b, xn, M, C, eps);
  RETURN_IF((int)cudaGetLastError());
  RETURN_IF(gemm<EPI_QKV>(xn, w_qkv, EpiArgs{b_qkv, nullptr, qkv, exact_gelu}, M, 3 * C, C, stream));
  RETURN_IF((int)tc::attention_fwd(qkv, attn, nullptr, B, N, C, H, stream));
  RETURN_IF(gemm<EPI_PROJ>(attn, w_proj, EpiArgs{b_proj, x, x1, exact_gelu}, M, C, C, stream));
  layernorm_kernel<float, T><<<ln_grid, ln_block, 0, stream>>>(x1, ln2_s, ln2_b, xn, M, C, eps);
  RETURN_IF((int)cudaGetLastError());
  RETURN_IF(gemm<EPI_FC1>(xn, w_fc1, EpiArgs{b_fc1, nullptr, hidden, exact_gelu}, M, F, C, stream));
  RETURN_IF(gemm<EPI_FC2>(hidden, w_fc2, EpiArgs{b_fc2, x1, out, exact_gelu}, M, C, F, stream));
#undef RETURN_IF
  return 0;
}

}  // namespace

extern "C" {

// Why the layer cannot run with heads D wide, or NULL. dtype as below.
const char* vit_layer_shape_error(int dtype, int D) {
  return dtype == 0 ? tc::attention_shape_error<float>(D) : tc::bf16_shape_error(D, 0);
}

const char* vit_layer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (x, weights, xn, qkv, attn, hidden, out).
// LayerNorm parameters and biases are float32; x1 is float32 scratch.
// The caller checks vit_layer_shape_error first.
// Returns 0 or the first CUDA error code.
int vit_layer_forward(int dtype, const void* x, const void* ln1_s, const void* ln1_b,
                      const void* w_qkv, const void* b_qkv, const void* w_proj,
                      const void* b_proj, const void* ln2_s, const void* ln2_b,
                      const void* w_fc1, const void* b_fc1, const void* w_fc2,
                      const void* b_fc2, void* xn, void* qkv, void* attn, void* x1,
                      void* hidden, void* out, int B, int N, int C, int H, int F,
                      float eps, int exact_gelu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32(p) static_cast<const float*>(p)
  if (dtype == 0) {
    return run_layer<float>(
        F32(x), F32(ln1_s), F32(ln1_b), F32(w_qkv), F32(b_qkv), F32(w_proj), F32(b_proj),
        F32(ln2_s), F32(ln2_b), F32(w_fc1), F32(b_fc1), F32(w_fc2), F32(b_fc2),
        static_cast<float*>(xn), static_cast<float*>(qkv), static_cast<float*>(attn),
        static_cast<float*>(x1), static_cast<float*>(hidden), static_cast<float*>(out),
        B, N, C, H, F, eps, exact_gelu, s);
  }
  using bf = __nv_bfloat16;
  return run_layer<bf>(
      static_cast<const bf*>(x), F32(ln1_s), F32(ln1_b), static_cast<const bf*>(w_qkv),
      F32(b_qkv), static_cast<const bf*>(w_proj), F32(b_proj), F32(ln2_s), F32(ln2_b),
      static_cast<const bf*>(w_fc1), F32(b_fc1), static_cast<const bf*>(w_fc2), F32(b_fc2),
      static_cast<bf*>(xn), static_cast<bf*>(qkv), static_cast<bf*>(attn),
      static_cast<float*>(x1), static_cast<bf*>(hidden), static_cast<bf*>(out),
      B, N, C, H, F, eps, exact_gelu, s);
#undef F32
}

}  // extern "C"
