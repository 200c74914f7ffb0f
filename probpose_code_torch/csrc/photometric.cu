// RTMPose's photometric median blur as hand-written CUDA for Hopper
// (sm_90a), on a batch of crops.
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

}  // extern "C"
