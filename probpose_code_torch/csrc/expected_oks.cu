// Expected-OKS heatmap decode as hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernels probpose_code_tpu/ops/pallas/expected_oks.py:
// heatmap_expected_value_pallas_fused (_fused_decode_kernel) and, through
// the conv-only entry, oks_convolve_pallas (_conv_kernel).
//
// One block per (b, k) heatmap. The block reads the H x W map once from
// device memory with reflect ("symmetric") indexing straight into shared
// memory, so no padded copy is ever written. Then, all in shared memory:
//   - the separable OKS filter: a pass along W over every padded row, then
//     one along H, with the keypoint's 1-D factor fk (the band of the banded
//     operators that the TPU kernel multiplies by);
//   - the argmax over the H x W result, the first index on ties;
//   - the 1-D Taylor shift from five taps, with the border guard and the 1e-6
//     guard for zero curvature;
//   - the raw heatmap value at the integer peak as the score.
// The locations come out already scaled to the model input.
//
// What bounds it: at B = 64, K = 17, 64 x 48 the decode reads 13.4 MB of
// heatmaps and writes 13 KB (4.0 us at 3.35 TB/s). The filter is 19
// multiply-adds per output in each pass: along W over the Hp x W padded rows,
// then along H over the H x W map, 0.290 GFLOP of f32 (4.3 us at 67 TFLOP/s
// outside the tensor cores). So the two bounds are close, the operations
// narrowly ahead. The design reads each heatmap exactly once, keeps every
// intermediate on chip, and filters separably (38 taps a pixel instead of 361
// for the 19 x 19 kernel). Filtering along W first runs the first pass over
// Hp x W outputs, fewer than the H x Wp of the other order when W < H, as
// at 64 x 48.
// The padded map (82 x 66 f32, 21.6 KB) and the first pass (82 x 48,
// 15.7 KB) are held together; the filtered map then overwrites the padded
// one, so 37.4 KB serve the flagship shape. Larger maps opt into more
// dynamic shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 64;

__device__ __forceinline__ int reflect(int i, int n) {
  // numpy/jnp.pad mode="symmetric" for a pad no wider than n
  if (i < 0) return -i - 1;
  if (i >= n) return 2 * n - 1 - i;
  return i;
}

size_t smem_bytes(int H, int W, int R) {
  const int Hp = H + 2 * R, Wp = W + 2 * R;
  return sizeof(float) * ((size_t)Hp * Wp + (size_t)Hp * W);
}

__global__ void __launch_bounds__(THREADS)
expected_oks_kernel(const float* __restrict__ heatmaps, const float* __restrict__ fk_table,
                    float* __restrict__ locs, float* __restrict__ vals,
                    float* __restrict__ conv_out, int K, int H, int W, int D,
                    float sx, float sy) {
  extern __shared__ float smem[];
  __shared__ float fk[MAX_TAPS];
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];

  const int R = D / 2;
  const int Hp = H + 2 * R, Wp = W + 2 * R;
  float* pad = smem;              // Hp x Wp, later the H x W filtered map
  float* wpass = smem + Hp * Wp;  // Hp x W
  float* conv = pad;

  const int map = blockIdx.x;
  const int k = map % K;
  const float* hm = heatmaps + (size_t)map * H * W;
  const int tid = threadIdx.x;

  for (int t = tid; t < D; t += THREADS) fk[t] = fk_table[k * D + t];
  for (int i = tid; i < Hp * Wp; i += THREADS) {
    const int pr = i / Wp, pc = i % Wp;
    pad[i] = hm[reflect(pr - R, H) * W + reflect(pc - R, W)];
  }
  __syncthreads();

  // along W: wpass[r, c] = sum_t fk[t] * pad[r, c + t], for every padded row
  for (int i = tid; i < Hp * W; i += THREADS) {
    const int r = i / W, c = i % W;
    float s = 0.f;
    for (int t = 0; t < D; ++t) s = fmaf(fk[t], pad[r * Wp + c + t], s);
    wpass[i] = s;
  }
  __syncthreads();

  // along H: conv[r, c] = sum_t fk[t] * wpass[r + t, c]
  for (int i = tid; i < H * W; i += THREADS) {
    const int r = i / W, c = i % W;
    float s = 0.f;
    for (int t = 0; t < D; ++t) s = fmaf(fk[t], wpass[(r + t) * W + c], s);
    conv[i] = s;
    if (conv_out != nullptr) conv_out[(size_t)map * H * W + i] = s;
  }
  __syncthreads();
  if (locs == nullptr) return;

  // argmax, first index on ties: each thread scans increasing indices
  float best = -__int_as_float(0x7f800000);  // -inf
  int bidx = H * W;
  for (int i = tid; i < H * W; i += THREADS) {
    const float v = conv[i];
    if (v > best) {
      best = v;
      bidx = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (ov > best || (ov == best && oi < bidx)) {
      best = ov;
      bidx = oi;
    }
  }
  if (tid % 32 == 0) {
    red_v[tid / 32] = best;
    red_i[tid / 32] = bidx;
  }
  __syncthreads();
  if (tid != 0) return;
  best = red_v[0];
  bidx = red_i[0];
  for (int w = 1; w < THREADS / 32; ++w) {
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < bidx)) {
      best = red_v[w];
      bidx = red_i[w];
    }
  }
  if (bidx >= H * W) bidx = 0;  // all-NaN map: jnp.argmax also gives 0 on no max

  const int xi = bidx % W, yi = bidx / W;
  const bool valid = xi > 0 && xi < W - 1 && yi > 0 && yi < H - 1;
  const int xc = min(max(xi, 1), W - 2), yc = min(max(yi, 1), H - 2);
  const float c = conv[yc * W + xc];
  const float left = conv[yc * W + xc - 1], right = conv[yc * W + xc + 1];
  const float up = conv[(yc - 1) * W + xc], down = conv[(yc + 1) * W + xc];
  const float dx = (right - left) * 0.5f;
  const float dy = (down - up) * 0.5f;
  float dxx = right + left - 2.0f * c;
  float dyy = down + up - 2.0f * c;
  dxx = dxx != 0.f ? dxx : 1e-6f;
  dyy = dyy != 0.f ? dyy : 1e-6f;
  const float fx = (float)xi + (valid ? -dx / dxx : 0.f);
  const float fy = (float)yi + (valid ? -dy / dyy : 0.f);
  locs[(size_t)map * 2 + 0] = fx * sx;
  locs[(size_t)map * 2 + 1] = fy * sy;
  vals[map] = hm[yi * W + xi];
}

}  // namespace

extern "C" {

const char* expected_oks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// heatmaps (BK = B*K maps of H x W, f32), fk (K x D, f32, D odd <= 64).
// locs (BK x 2) and vals (BK) may be null for the conv-only entry; conv_out
// (BK x H x W) may be null for the decode-only entry. Returns 0 or a CUDA
// error code.
int expected_oks_run(const void* heatmaps, const void* fk, void* locs, void* vals,
                     void* conv_out, int BK, int K, int H, int W, int D, float sx, float sy,
                     void* stream) {
  if (D > MAX_TAPS || D % 2 == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, W, D / 2);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(expected_oks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  expected_oks_kernel<<<BK, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heatmaps), static_cast<const float*>(fk),
      static_cast<float*>(locs), static_cast<float*>(vals), static_cast<float*>(conv_out),
      K, H, W, D, sx, sy);
  return (int)cudaGetLastError();
}

}  // extern "C"
