// The RTMPose recipes' photometric median blur and PhotometricDistortion as
// hand-written CUDA for Hopper (sm_90a), on a batch of crops.
//
// It replaces no TPU kernel: the JAX pipeline runs Albumentation's native
// MedianBlur on the host with OpenCV
// (probpose_code_tpu/datasets/transforms/common.py:792-871), on each uint8
// crop. The port's crops exist only on the card, and the plain PyTorch
// version (probpose_code_torch/ops/photometric.py:median_blur, pinned to
// cv2 bit for bit) sorts each pixel's window there: about 14 ms of a
// 256-crop batch of the recipe's draws (H100 80GB HBM3, 700 W).
//
// median_kernel<K>: one thread a (pixel, channel), its K x K window (the
// border replicated, as cv2.medianBlur's) in registers as ints, and the
// median by a binary search over the 8 bits of the value: the largest t
// with fewer than (K² + 1) / 2 window values below t, 8 passes of K²
// compares. Exact for 8-bit values, no sort, no scratch memory.
//
// distortion_kernel: PhotometricDistortion (the JAX transform's NumPy and
// cv2 steps, probpose_code_tpu/datasets/transforms/common.py:384-406), one
// thread a pixel, each crop's row of 8 floats: brightness, contrast, the
// saturation and hue of its HSV step, the contrast after it, the channel
// order. In PyTorch (ops/photometric.py:photometric_distortion, about 25
// passes over the batch) around two gathers from the tables it took 3.46 ms
// of a 256-crop batch, 2% of a body8 training step (H100 80GB HBM3, 700 W;
// 7.7 ms through the plain conversions). Here the float32
// steps run in registers, each one rounding (__fadd_rn / __fmul_rn: no
// contraction into a multiply-add), the hue's remainder as NumPy's float32
// one (an exact fmodf, plus 180 where it is negative), and the colour
// round trip through the two tables of cv2's conversions over every 8-bit
// input that ops/photometric.py:hsv_tables fills (hue 180 included).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int K>
__global__ void median_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
                              long long elements) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= elements) return;
  const int c = (int)(e % 3);
  const long long pixel = e / 3;
  const int x = (int)(pixel % W);
  const int y = (int)((pixel / W) % H);
  const float* img = in + (pixel - (long long)y * W - x) * 3 + c;
  int vals[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int yy = min(max(y + dy - K / 2, 0), H - 1);
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int xx = min(max(x + dx - K / 2, 0), W - 1);
      vals[dy * K + dx] = (int)__ldg(img + ((long long)yy * W + xx) * 3);
    }
  }
  constexpr int RANK = (K * K + 1) / 2;
  int result = 0;
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const int candidate = result | (1 << bit);
    int below = 0;
#pragma unroll
    for (int i = 0; i < K * K; ++i) below += vals[i] < candidate;
    if (below < RANK) result = candidate;
  }
  out[e] = (float)result;
}

__device__ __forceinline__ int truncate_to_byte(float x) {  // clip(0, 255).astype(uint8)
  return (int)fminf(fmaxf(x, 0.0f), 255.0f);
}

__global__ void distortion_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  const float* __restrict__ params, const unsigned char* __restrict__ to_hsv,
                                  const unsigned char* __restrict__ to_bgr, long long crop_pixels,
                                  long long pixels) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pixels) return;
  const float* row = params + (p / crop_pixels) * 8;
  const float brightness = row[0], contrast = row[1], saturation = row[2], hue = row[3], after = row[4];
  int bgr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bgr[c] = truncate_to_byte(__fmul_rn(__fadd_rn(__ldg(in + 3 * p + c), brightness), contrast));
  }
  const unsigned char* hsv = to_hsv + 3 * ((bgr[2] << 16) | (bgr[1] << 8) | bgr[0]);
  float h = fmodf(__fadd_rn((float)hsv[0], hue), 180.0f);
  if (h < 0.0f) h = __fadd_rn(h, 180.0f);
  const int s = truncate_to_byte(__fmul_rn((float)hsv[1], saturation));
  const unsigned char* back = to_bgr + 3 * ((truncate_to_byte(h) << 16) | (s << 8) | hsv[2]);
  float result[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) result[c] = (float)truncate_to_byte(__fmul_rn((float)back[c], after));
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * p + c] = result[min(max((int)row[5 + c], 0), 2)];  // a permutation of 0..2
}

}  // namespace

extern "C" {

const char* photometric_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// in, out: n x H x W x 3 floats; k: 3, 5 or 7. Returns 0 or a CUDA error code.
int photometric_median(const void* in, void* out, int n, int H, int W, int k, void* stream) {
  const long long elements = (long long)n * H * W * 3;
  if (elements <= 0) return 0;
  const unsigned blocks = (unsigned)((elements + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  if (k == 3) {
    median_kernel<3><<<blocks, THREADS, 0, s>>>(i, o, H, W, elements);
  } else if (k == 5) {
    median_kernel<5><<<blocks, THREADS, 0, s>>>(i, o, H, W, elements);
  } else if (k == 7) {
    median_kernel<7><<<blocks, THREADS, 0, s>>>(i, o, H, W, elements);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// in, out: n x H x W x 3 floats (integer values 0..255); params: n x 8 floats; to_hsv: 2^24 x 3 bytes at
// r << 16 | g << 8 | b, to_bgr: 181 x 2^16 x 3 bytes at h << 16 | s << 8 | v. Returns 0 or a CUDA error code.
int photometric_distortion(const void* in, void* out, const void* params, const void* to_hsv, const void* to_bgr,
                           int n, int H, int W, void* stream) {
  const long long crop_pixels = (long long)H * W;
  const long long pixels = (long long)n * crop_pixels;
  if (pixels <= 0) return 0;
  const unsigned blocks = (unsigned)((pixels + THREADS - 1) / THREADS);
  distortion_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<const float*>(params),
      static_cast<const unsigned char*>(to_hsv), static_cast<const unsigned char*>(to_bgr), crop_pixels, pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
