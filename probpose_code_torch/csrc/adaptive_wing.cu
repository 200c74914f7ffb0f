// AdaptiveWingLoss over heatmaps, forward and backward, as hand-written CUDA
// for Hopper (sm_90a), f32.
//
// It replaces no TPU kernel: the JAX package computes the loss with XLA's
// elementwise operations (probpose_code_tpu/models/losses/heatmap_loss.py:
// 121-157). In PyTorch (probpose_code_torch/ops/kernels/adaptive_wing.py:
// adaptive_wing_loss_plain, its plain twin) the loss and its backward make
// some twenty passes over the (B, K, H, W) maps: 4.07 ms at HRNetV2-w18's
// WFLW step (64 x 98 x 64 x 64), 1.96% of that step's device time (H100
// 80GB HBM3, 700 W), at the 2% bar. Here each is one pass.
//
// For an error d = |output - target| and a = alpha - target:
//   d < theta:  L = omega log1p((d / eps)^a),
//               dL/dd = omega a (d / eps)^(a - 1) / (eps (1 + (d / eps)^a));
//   else:       L = A d - C,  dL/dd = A,
//   A = omega a (theta / eps)^(a - 1) / (eps (1 + (theta / eps)^a)),
//   C = theta A - omega log1p((theta / eps)^a),
// each map weighed by its keypoint's weight, the mean over every element.
//
// adaptive_wing_forward_kernel: a grid-stride loop over the elements, the
// block's sum (a fixed tree in shared memory) into one partial;
// adaptive_wing_reduce sums the partials in float64, in order, and scales
// by loss_weight / N. adaptive_wing_backward_kernel: the gradient of each
// element, the upstream scalar read on the card (no host sync), sign(0) = 0
// as torch's abs. Both read the output and the target once (8 bytes an
// element), the backward writes 4: memory-bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FORWARD_BLOCKS = 1024;  // the forward's partial sums

struct Params {
  float alpha, omega, eps, theta;
};

__device__ __forceinline__ void wing(float o, float t, const Params& p, float* loss, float* slope) {
  const float d = fabsf(o - t);
  const float a = p.alpha - t;
  const float r = p.theta / p.eps;
  if (d < p.theta) {
    const float q = powf(d / p.eps, a);
    *loss = p.omega * log1pf(q);
    *slope = p.omega * a * powf(d / p.eps, a - 1.f) / (p.eps * (1.f + q));
  } else {
    const float ra = powf(r, a);
    const float A = p.omega * (1.f / (1.f + ra)) * a * powf(r, a - 1.f) / p.eps;
    *loss = A * d - (p.theta * A - p.omega * log1pf(ra));
    *slope = A;
  }
  *slope = o > t ? *slope : (o < t ? -*slope : 0.f);
}

__global__ void adaptive_wing_forward_kernel(const float* __restrict__ out, const float* __restrict__ target,
                                             const float* __restrict__ weights, float* __restrict__ partial,
                                             long long elements, long long map_size, Params p) {
  float s = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < elements;
       i += (long long)gridDim.x * THREADS) {
    float loss, slope;
    wing(__ldg(out + i), __ldg(target + i), p, &loss, &slope);
    s += weights ? loss * __ldg(weights + i / map_size) : loss;
  }
  __shared__ float sums[THREADS];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = sums[0];
}

__global__ void adaptive_wing_reduce(const float* __restrict__ partial, float* __restrict__ loss, int blocks,
                                     double scale) {
  if (threadIdx.x != 0) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[b];
  *loss = (float)(s * scale);
}

__global__ void adaptive_wing_backward_kernel(const float* __restrict__ out, const float* __restrict__ target,
                                              const float* __restrict__ weights, const float* __restrict__ dloss,
                                              float* __restrict__ grad, long long elements, long long map_size,
                                              float scale, Params p) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= elements) return;
  float loss, slope;
  wing(__ldg(out + i), __ldg(target + i), p, &loss, &slope);
  const float w = weights ? __ldg(weights + i / map_size) : 1.f;
  grad[i] = __ldg(dloss) * scale * w * slope;
}

}  // namespace

extern "C" {

const char* adaptive_wing_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int adaptive_wing_partials() { return FORWARD_BLOCKS; }

// out, target: n maps of map_size floats; weights: n floats or null; partial: adaptive_wing_partials() floats;
// loss: 1 float, the mean times loss_weight.
int adaptive_wing_forward(const void* out, const void* target, const void* weights, void* partial, void* loss,
                          long long n, long long map_size, float alpha, float omega, float eps, float theta,
                          float loss_weight, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long elements = n * map_size;
  if (elements <= 0) return 0;
  const Params p{alpha, omega, eps, theta};
  adaptive_wing_forward_kernel<<<FORWARD_BLOCKS, THREADS, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(target), static_cast<const float*>(weights),
      static_cast<float*>(partial), elements, map_size, p);
  adaptive_wing_reduce<<<1, 32, 0, s>>>(static_cast<const float*>(partial), static_cast<float*>(loss),
                                        FORWARD_BLOCKS, (double)loss_weight / (double)elements);
  return (int)cudaGetLastError();
}

// dloss: 1 float on the card, the loss's upstream gradient; grad: the output's gradient, n x map_size floats.
int adaptive_wing_backward(const void* out, const void* target, const void* weights, const void* dloss, void* grad,
                           long long n, long long map_size, float alpha, float omega, float eps, float theta,
                           float loss_weight, void* stream) {
  const long long elements = n * map_size;
  if (elements <= 0) return 0;
  const Params p{alpha, omega, eps, theta};
  const unsigned blocks = (unsigned)((elements + THREADS - 1) / THREADS);
  adaptive_wing_backward_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const float*>(target), static_cast<const float*>(weights),
      static_cast<const float*>(dloss), static_cast<float*>(grad), elements, map_size,
      (float)((double)loss_weight / (double)elements), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
