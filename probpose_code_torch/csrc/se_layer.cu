// The squeeze-and-excite layer, forward and backward, as hand-written CUDA
// for Hopper (sm_90a), f32:
//   y[b, c, p] = x[b, c, p] g[b, c],  g = gate(W2 relu(W1 mean_p(x) + b1) + b2),
// x (B, C, P) with P = H W, W1 (mid, C), W2 (C, mid); the gate a sigmoid or
// the hard sigmoid clamp((z + 3) / 6, 0, 1).
//
// It replaces no TPU kernel: the JAX package computes the layer with XLA's
// mean, Dense layers and product (probpose_code_tpu/models/backbones/
// classic.py:SELayer, vipnas.py). In PyTorch (ops/kernels/se_layer.py:
// se_layer_plain, its plain twin) the layer reads its maps three times
// forward (mean, product), its backward writes dy * x and dy * g before
// summing them and adds the pooled branch's broadcast gradient in another
// pass, and its two products on the pooled vectors take some twenty small
// launches; over ViPNAS-Res50's training step at B = 64 it took 2.28-2.50%.
// Here, three launches forward and four backward:
//
// se_reduce_kernel: one warp a (b, c) plane, eight planes a block: the
// plane's mean (x alone) or its dot product with a second map (dy . x, the
// gate's gradient), 16 bytes a lane where the plane's size allows, summed
// in registers and over the warp by shuffles in a fixed order
// (deterministic). Reads the maps once, writes a float a plane.
// se_excite_forward_kernel: one block a sample: z1 = W1 mean + b1 (a thread
// a hidden unit), then z2 = W2 relu(z1) + b2 and the gate (a thread a
// channel), the sample's vectors in shared memory.
// se_excite_backward_kernel: one block a sample: dz2 = dgate gate'(z2), dz1
// = (z1 > 0) W2^T dz2, and the mean's gradient W1^T dz1 over P.
// se_weight_grad_kernel: W1's, b1's, W2's and b2's gradients, a thread an
// element, each a sum over the batch in a fixed order.
// se_scale_kernel: out = a g[plane] (+ c[plane]): the forward's product,
// and the backward's dx = dy g + dmean / P in one pass. 16 bytes a thread
// where the plane's size allows. Reads a, writes out.
//
// The passes over the maps are memory-bound: 12 bytes an element forward
// (x read twice, y written) against the bound's 8 (x read once, y
// written), and 16 backward (dy and x read, then dy read and dx written)
// against 12; the excitation's work is a few thousand operations a sample.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;

__global__ void se_reduce_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                                 long long planes, int P, float scale, bool vec) {
  const long long plane = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= planes) return;
  const float* pa = a + plane * P;
  const float* pb = b ? b + plane * P : nullptr;
  float acc = 0.f;
  if (vec) {  // P a multiple of 4, every plane 16-byte aligned
    for (int q = lane; q < P / 4; q += 32) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(pa) + q);
      if (pb) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(pb) + q);
        acc += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
      } else {
        acc += u.x + u.y + u.z + u.w;
      }
    }
  } else {
    for (int p = lane; p < P; p += 32) acc += pb ? __ldg(pa + p) * __ldg(pb + p) : __ldg(pa + p);
  }
  for (int offset = 16; offset > 0; offset /= 2) acc += __shfl_down_sync(0xffffffffu, acc, offset);
  if (lane == 0) out[plane] = acc * scale;
}

__global__ void se_scale_kernel(const float* __restrict__ a, const float* __restrict__ g, const float* __restrict__ c,
                                float* __restrict__ out, long long n, int P, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec) {  // 4 elements a thread, never across two planes (P a multiple of 4)
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n / 4; q += stride) {
      const long long plane = 4 * q / P;
      const float s = __ldg(g + plane), t = c ? __ldg(c + plane) : 0.f;
      const float4 u = __ldg(reinterpret_cast<const float4*>(a) + q);
      reinterpret_cast<float4*>(out)[q] = make_float4(u.x * s + t, u.y * s + t, u.z * s + t, u.w * s + t);
    }
    return;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long plane = i / P;
    out[i] = __ldg(a + i) * __ldg(g + plane) + (c ? __ldg(c + plane) : 0.f);
  }
}

__device__ __forceinline__ float gate_of(float z, bool hard) {
  return hard ? fminf(fmaxf((z + 3.f) / 6.f, 0.f), 1.f) : 1.f / (1.f + expf(-z));
}

__global__ void se_excite_forward_kernel(const float* __restrict__ pooled, const float* __restrict__ w1,
                                         const float* __restrict__ b1, const float* __restrict__ w2,
                                         const float* __restrict__ b2, float* __restrict__ z1,
                                         float* __restrict__ z2, float* __restrict__ gate, int C, int M, bool hard) {
  extern __shared__ float smem[];  // pooled[C], relu(z1)[M]
  float* p = smem;
  float* h = smem + C;
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) p[c] = __ldg(pooled + b * C + c);
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc = __ldg(b1 + m);
    const float* row = w1 + (long long)m * C;
    for (int c = 0; c < C; ++c) acc += __ldg(row + c) * p[c];
    z1[b * M + m] = acc;
    h[m] = fmaxf(acc, 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = __ldg(b2 + c);
    const float* row = w2 + (long long)c * M;
    for (int m = 0; m < M; ++m) acc += __ldg(row + m) * h[m];
    z2[b * C + c] = acc;
    gate[b * C + c] = gate_of(acc, hard);
  }
}

__global__ void se_excite_backward_kernel(const float* __restrict__ dgate, const float* __restrict__ z1,
                                          const float* __restrict__ z2, const float* __restrict__ gate,
                                          const float* __restrict__ w1, const float* __restrict__ w2,
                                          float* __restrict__ dz1, float* __restrict__ dz2,
                                          float* __restrict__ dmean, int C, int M, float inv_p, bool hard) {
  extern __shared__ float smem[];  // dz2[C], dz1[M]
  float* d2 = smem;
  float* d1 = smem + C;
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float z = __ldg(z2 + b * C + c), g = __ldg(gate + b * C + c), dg = __ldg(dgate + b * C + c);
    // the hard sigmoid's slope as torch.clamp's gradient has it: 1/6 on [-3, 3], its ends included
    const float d = hard ? (z >= -3.f && z <= 3.f ? dg / 6.f : 0.f) : dg * g * (1.f - g);
    d2[c] = d;
    dz2[b * C + c] = d;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += __ldg(w2 + (long long)c * M + m) * d2[c];
    const float d = __ldg(z1 + b * M + m) > 0.f ? acc : 0.f;
    d1[m] = d;
    dz1[b * M + m] = d;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc += __ldg(w1 + (long long)m * C + c) * d1[m];
    dmean[b * C + c] = acc * inv_p;
  }
}

// dw1 (M, C), db1 (M), dw2 (C, M), db2 (C), in that order in one flat index
__global__ void se_weight_grad_kernel(const float* __restrict__ dz1, const float* __restrict__ dz2,
                                      const float* __restrict__ pooled, const float* __restrict__ z1,
                                      float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2,
                                      float* __restrict__ db2, int B, int C, int M) {
  const long long n1 = (long long)M * C, n2 = n1 + M, n3 = n2 + (long long)C * M, n4 = n3 + C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < n1) {
      const int m = (int)(i / C), c = (int)(i - (long long)m * C);
      for (int b = 0; b < B; ++b) acc += __ldg(dz1 + (long long)b * M + m) * __ldg(pooled + (long long)b * C + c);
      dw1[i] = acc;
    } else if (i < n2) {
      const int m = (int)(i - n1);
      for (int b = 0; b < B; ++b) acc += __ldg(dz1 + (long long)b * M + m);
      db1[m] = acc;
    } else if (i < n3) {
      const long long j = i - n2;
      const int c = (int)(j / M), m = (int)(j - (long long)c * M);
      for (int b = 0; b < B; ++b)
        acc += __ldg(dz2 + (long long)b * C + c) * fmaxf(__ldg(z1 + (long long)b * M + m), 0.f);
      dw2[j] = acc;
    } else {
      const int c = (int)(i - n3);
      for (int b = 0; b < B; ++b) acc += __ldg(dz2 + (long long)b * C + c);
      db2[c] = acc;
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned scale_blocks(long long work) {
  const long long blocks = (work + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace

extern "C" {

const char* se_layer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// out[plane] = scale * sum_p a[plane, p] (* b[plane, p] where b is given); a, b: planes x P floats.
int se_reduce(const void* a, const void* b, void* out, long long planes, int P, float scale, void* stream) {
  if (planes <= 0 || P <= 0) return 0;
  const bool vec = P % 4 == 0 && aligned(a) && (!b || aligned(b));
  se_reduce_kernel<<<(unsigned)((planes + WARPS - 1) / WARPS), 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), planes, P, scale, vec);
  return (int)cudaGetLastError();
}

// out[plane, p] = a[plane, p] g[plane] (+ c[plane] where c is given); a, out: planes x P floats.
int se_scale(const void* a, const void* g, const void* c, void* out, long long planes, int P, void* stream) {
  const long long n = planes * P;
  if (n <= 0) return 0;
  const bool vec = P % 4 == 0 && aligned(a) && aligned(out);
  se_scale_kernel<<<scale_blocks(vec ? n / 4 : n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(c),
      static_cast<float*>(out), n, P, vec);
  return (int)cudaGetLastError();
}

// One block a sample: pooled (B, C) -> z1 (B, M), z2 and gate (B, C); w1 (M, C), b1 (M), w2 (C, M), b2 (C).
int se_excite_forward(const void* pooled, const void* w1, const void* b1, const void* w2, const void* b2, void* z1,
                      void* z2, void* gate, int B, int C, int M, int hard, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  se_excite_forward_kernel<<<B, 256, (C + M) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pooled), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(z1), static_cast<float*>(z2),
      static_cast<float*>(gate), C, M, hard != 0);
  return (int)cudaGetLastError();
}

// One block a sample: dgate (B, C) -> dz1 (B, M), dz2 (B, C) and the mean's gradient over P (B, C).
int se_excite_backward(const void* dgate, const void* z1, const void* z2, const void* gate, const void* w1,
                       const void* w2, void* dz1, void* dz2, void* dmean, int B, int C, int M, float inv_p, int hard,
                       void* stream) {
  if (B <= 0 || C <= 0) return 0;
  se_excite_backward_kernel<<<B, 256, (C + M) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dgate), static_cast<const float*>(z1), static_cast<const float*>(z2),
      static_cast<const float*>(gate), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dz1), static_cast<float*>(dz2), static_cast<float*>(dmean), C, M, inv_p, hard != 0);
  return (int)cudaGetLastError();
}

// The weights' and biases' gradients from dz1 (B, M), dz2 (B, C), pooled (B, C) and z1 (B, M).
int se_weight_grad(const void* dz1, const void* dz2, const void* pooled, const void* z1, void* dw1, void* db1,
                   void* dw2, void* db2, int B, int C, int M, void* stream) {
  const long long n = 2LL * M * C + M + C;
  if (B <= 0 || n <= 0) return 0;
  se_weight_grad_kernel<<<scale_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz1), static_cast<const float*>(dz2), static_cast<const float*>(pooled),
      static_cast<const float*>(z1), static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), B, C, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
