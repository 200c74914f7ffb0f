// LayerNorm over the last axis with flax's semantics, forward and backward, as
// hand-written CUDA for Hopper (sm_90a), f32, rows of C:
//   mean_r = E[x],  var_r = max(E[x^2] - mean_r^2, 0),  inv_r = rsqrt(var_r + eps),
//   y = (x - mean_r) inv_r w + b;
// backward, x^ = (x - mean) inv and g = dy w:
//   dx = inv (g - mean_c(g) - x^ mean_c(g x^)),  dw = sum_r(dy x^),  db = sum_r(dy).
//
// It replaces no TPU kernel: the JAX package's LayerNorm (flax.linen.LayerNorm
// in probpose_code_tpu/models/backbones/transformers.py and nas_and_3d.py) is
// XLA's. In PyTorch (ops/kernels/layer_norm.py:layer_norm_plain, the plain
// twin, the port's vit.layer_norm_f32) the forward takes five passes over the
// rows and autograd's backward about eight; on the card LayerNorm took 17% of
// Swin-T's B = 32 training step, 17% of HRFormer-small's and 23% of
// PVTv2-b2's B = 64 (the 2% rule, PERF.md section 6).
//
// ln_forward_kernel: a warp a row: its sums of x and x^2 by shuffles in a
// fixed order, then y; mean and inv kept for the backward (one launch).
// ln_backward_rows_kernel: a warp a row: the sums of g and g x^, then dx.
// ln_backward_cols_kernel: each block's partial sums of dy x^ and dy over a
// chunk of rows for 32 columns; ln_backward_finish_kernel adds a column's
// partials in a fixed order (deterministic) into dw and db. Three launches
// backward. Memory-bound: the bound is 8 bytes an element forward (x read, y
// written) and 12 backward (dy and x read, dx written); the forward reads x
// twice (the second from L1 or L2: a row is at most 12 KB), the backward
// reads dy and x twice.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 32;
constexpr int ROWS = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ln_forward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                  const float* __restrict__ b, float* __restrict__ y, float* __restrict__ mean,
                                  float* __restrict__ inv, long long R, int C, float eps) {
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;
  const float* xr = x + r * C;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = __ldg(xr + c);
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float m = s1 / C;
  const float ir = rsqrtf(fmaxf(s2 / C - m * m, 0.f) + eps);
  float* yr = y + r * C;
  for (int c = lane; c < C; c += 32) yr[c] = (__ldg(xr + c) - m) * ir * __ldg(w + c) + __ldg(b + c);
  if (lane == 0) {
    mean[r] = m;
    inv[r] = ir;
  }
}

__global__ void ln_backward_rows_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                                        const float* __restrict__ w, const float* __restrict__ mean,
                                        const float* __restrict__ inv, float* __restrict__ dx, long long R, int C) {
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;
  const float* dyr = dy + r * C;
  const float* xr = x + r * C;
  const float m = mean[r], ir = inv[r];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float g = __ldg(dyr + c) * __ldg(w + c);
    s1 += g;
    s2 += g * (__ldg(xr + c) - m) * ir;
  }
  s1 = warp_sum(s1) / C;
  s2 = warp_sum(s2) / C;
  float* dxr = dx + r * C;
  for (int c = lane; c < C; c += 32) {
    const float g = __ldg(dyr + c) * __ldg(w + c);
    dxr[c] = ir * (g - s1 - (__ldg(xr + c) - m) * ir * s2);
  }
}

// grid (ceil(C / 32), S), block (32, 8): partial[s, c] = (sum dy x^, sum dy) over rows [s per, (s + 1) per).
__global__ void ln_backward_cols_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                                        const float* __restrict__ mean, const float* __restrict__ inv,
                                        float* __restrict__ partial, long long R, int C, long long per) {
  const int c = blockIdx.x * COLS + threadIdx.x, s = blockIdx.y;
  const long long r0 = s * per, r1 = min(R, r0 + per);
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    for (long long r = r0 + threadIdx.y; r < r1; r += ROWS) {
      const float d = __ldg(dy + r * C + c);
      a1 += d * (__ldg(x + r * C + c) - __ldg(mean + r)) * __ldg(inv + r);
      a2 += d;
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

__global__ void ln_backward_finish_kernel(const float* __restrict__ partial, int S, int C, float* __restrict__ dw,
                                          float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float t1 = 0.f, t2 = 0.f;
  for (int s = 0; s < S; ++s) {
    t1 += partial[((long long)s * C + c) * 2];
    t2 += partial[((long long)s * C + c) * 2 + 1];
  }
  dw[c] = t1;
  db[c] = t2;
}

constexpr long long ROWS_PER_CHUNK = 512;

int chunks(long long R) { return (int)((R + ROWS_PER_CHUNK - 1) / ROWS_PER_CHUNK); }

unsigned row_blocks(long long R) { return (unsigned)((R + WARPS - 1) / WARPS); }

}  // namespace

extern "C" {

const char* layer_norm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The number of floats of scratch the backward's column sums of R rows of C take.
long long layer_norm_scratch(long long R, int C) { return (long long)chunks(R) * C * 2; }

// y (R, C) = LayerNorm(x); mean and inv (R each) for the backward.
int layer_norm_forward(const void* x, const void* w, const void* b, void* y, void* mean, void* inv, long long R, int C,
                       float eps, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  ln_forward_kernel<<<row_blocks(R), 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<float*>(mean), static_cast<float*>(inv), R, C, eps);
  return (int)cudaGetLastError();
}

// dx (R, C), dw and db (C) from dy and the forward's x, w, mean and inv; partial: layer_norm_scratch floats.
int layer_norm_backward(const void* dy, const void* x, const void* w, const void* mean, const void* inv, void* dx,
                        void* dw, void* db, void* partial, long long R, int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dyf = static_cast<const float*>(dy);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  const float* inf = static_cast<const float*>(inv);
  ln_backward_rows_kernel<<<row_blocks(R), 32 * WARPS, 0, st>>>(dyf, xf, static_cast<const float*>(w), mf, inf,
                                                                 static_cast<float*>(dx), R, C);
  int code = (int)cudaGetLastError();
  if (code) return code;
  const int S = chunks(R);
  float* pf = static_cast<float*>(partial);
  ln_backward_cols_kernel<<<dim3((C + COLS - 1) / COLS, S), dim3(COLS, ROWS), 0, st>>>(dyf, xf, mf, inf, pf, R, C,
                                                                                        ROWS_PER_CHUNK);
  code = (int)cudaGetLastError();
  if (code) return code;
  ln_backward_finish_kernel<<<(C + 127) / 128, 128, 0, st>>>(pf, S, C, static_cast<float*>(dw),
                                                             static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // extern "C"
