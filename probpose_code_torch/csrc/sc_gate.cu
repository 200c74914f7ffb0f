// SCNet's self-calibration gate, forward and backward, as hand-written CUDA
// for Hopper (sm_90a), f32:
//   out = k3 * sigmoid(x + up(k2)),
// x and k3 (B, C, H, W), k2 (B, C, h, w) the pooled branch, up the bilinear
// resize to H x W with half-pixel centres (PyTorch's F.interpolate,
// mode="bilinear", align_corners=False: source s = (in / out) (d + 0.5) -
// 0.5, clamped at 0; rows i0 = floor(s) and i0 + 1, the second clamped to
// the last row).
//
// It replaces no TPU kernel: the JAX package computes the gate with XLA's
// resize and elementwise operations (probpose_code_tpu/models/backbones/
// classic.py:330-333). In PyTorch (probpose_code_torch/ops/kernels/
// sc_gate.py: self_calibration_plain, its plain twin) the gate makes some
// ten passes over the (B, C, H, W) maps forward and more backward, with
// the resize's backward scattering by atomics; over SCNet-50's training
// step at B = 64 it passed the 2% bar. Here:
//
// sc_gate_forward_kernel: one thread an output element (a grid-stride
// loop), the four taps of k2 read where the element needs them (k2 is 1/16
// of x: it stays in L1 and L2). Reads x and k3, writes out: 12 bytes an
// element and k2 once, memory-bound.
// sc_gate_backward_kernel: for each element s = sigmoid(x + up(k2)) again,
// dk3 = dy s and dx = dy k3 s (1 - s), the gradient of up(k2) too. Reads
// dy, x and k3, writes dx and dk3: 20 bytes an element.
// sc_gate_resize_backward_kernel: each k2 element gathers, in a fixed
// order, the dx of the output rows and columns whose taps reach it, each
// times its two weights (no atomics: deterministic). The rows that reach
// source row i are those whose s lies in (i - 1, i + 1); the loop takes a
// window one row wider on each side and keeps the weights that land on i.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Taps {
  int i0, i1;    // the two source rows (or columns), i1 == i0 at the last
  float l0, l1;  // their weights
};

__device__ __forceinline__ Taps taps(int d, int in, float scale) {
  float s = scale * ((float)d + 0.5f) - 0.5f;
  s = s < 0.f ? 0.f : s;
  const int i0 = (int)s;
  const float l1 = s - (float)i0;
  return {i0, i0 + (i0 < in - 1 ? 1 : 0), 1.f - l1, l1};
}

__device__ __forceinline__ float upsample(const float* __restrict__ k2, const Taps& ty, const Taps& tx, int w) {
  return ty.l0 * (tx.l0 * __ldg(k2 + ty.i0 * w + tx.i0) + tx.l1 * __ldg(k2 + ty.i0 * w + tx.i1)) +
         ty.l1 * (tx.l0 * __ldg(k2 + ty.i1 * w + tx.i0) + tx.l1 * __ldg(k2 + ty.i1 * w + tx.i1));
}

struct Shape {
  long long elements;  // B * C * H * W
  int H, W, h, w;
  float sy, sx;  // h / H, w / W
};

__device__ __forceinline__ float gate_at(const float* __restrict__ x, const float* __restrict__ k2, long long i,
                                         const Shape& p) {
  const long long plane = i / ((long long)p.H * p.W);
  const int rest = (int)(i - plane * p.H * p.W);
  const int y = rest / p.W, xx = rest - y * p.W;
  const float u = upsample(k2 + plane * p.h * p.w, taps(y, p.h, p.sy), taps(xx, p.w, p.sx), p.w);
  return 1.f / (1.f + expf(-(__ldg(x + i) + u)));
}

__global__ void sc_gate_forward_kernel(const float* __restrict__ x, const float* __restrict__ k2,
                                       const float* __restrict__ k3, float* __restrict__ out, Shape p) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < p.elements;
       i += (long long)gridDim.x * THREADS) {
    out[i] = __ldg(k3 + i) * gate_at(x, k2, i, p);
  }
}

__global__ void sc_gate_backward_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                                        const float* __restrict__ k2, const float* __restrict__ k3,
                                        float* __restrict__ dx, float* __restrict__ dk3, Shape p) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < p.elements;
       i += (long long)gridDim.x * THREADS) {
    const float s = gate_at(x, k2, i, p);
    const float g = __ldg(dy + i);
    dk3[i] = g * s;
    dx[i] = g * __ldg(k3 + i) * s * (1.f - s);
  }
}

// the weight with which output row (or column) d reaches source row i
__device__ __forceinline__ float reach(int d, int i, int in, float scale) {
  const Taps t = taps(d, in, scale);
  return (t.i0 == i ? t.l0 : 0.f) + (t.i1 == i ? t.l1 : 0.f);
}

__global__ void sc_gate_resize_backward_kernel(const float* __restrict__ dup, float* __restrict__ dk2,
                                               long long small, Shape p) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= small) return;
  const long long plane = j / ((long long)p.h * p.w);
  const int rest = (int)(j - plane * p.h * p.w);
  const int i = rest / p.w, k = rest - i * p.w;
  // output rows whose source lies in (i - 1, i + 1), one more on each side
  const int y0 = max(0, (int)floorf(((float)i - 0.5f) / p.sy - 0.5f) - 1);
  const int y1 = min(p.H - 1, (int)ceilf(((float)i + 1.5f) / p.sy - 0.5f) + 1);
  const int x0 = max(0, (int)floorf(((float)k - 0.5f) / p.sx - 0.5f) - 1);
  const int x1 = min(p.W - 1, (int)ceilf(((float)k + 1.5f) / p.sx - 0.5f) + 1);
  const float* g = dup + plane * p.H * p.W;
  float sum = 0.f;
  for (int y = y0; y <= y1; ++y) {
    const float wy = reach(y, i, p.h, p.sy);
    if (wy == 0.f) continue;
    float row = 0.f;
    for (int xx = x0; xx <= x1; ++xx) {
      const float wx = reach(xx, k, p.w, p.sx);
      if (wx != 0.f) row += wx * __ldg(g + y * p.W + xx);
    }
    sum += wy * row;
  }
  dk2[j] = sum;
}

Shape shape_of(long long planes, int H, int W, int h, int w) {
  return {planes * H * W, H, W, h, w, (float)h / (float)H, (float)w / (float)W};
}

unsigned blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 132 * 32 ? b : 132 * 32);
}

}  // namespace

extern "C" {

const char* sc_gate_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x, k3, out: planes x H x W floats; k2: planes x h x w floats (planes = B * C).
int sc_gate_forward(const void* x, const void* k2, const void* k3, void* out, long long planes, int H, int W, int h,
                    int w, void* stream) {
  const Shape p = shape_of(planes, H, W, h, w);
  if (p.elements <= 0) return 0;
  sc_gate_forward_kernel<<<blocks_for(p.elements), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k2), static_cast<const float*>(k3),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

// dy: the output's gradient; dx, dk3 as x; dk2 as k2.
int sc_gate_backward(const void* dy, const void* x, const void* k2, const void* k3, void* dx, void* dk2, void* dk3,
                     long long planes, int H, int W, int h, int w, void* stream) {
  const Shape p = shape_of(planes, H, W, h, w);
  if (p.elements <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sc_gate_backward_kernel<<<blocks_for(p.elements), THREADS, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(x), static_cast<const float*>(k2),
      static_cast<const float*>(k3), static_cast<float*>(dx), static_cast<float*>(dk3), p);
  const long long small = planes * h * w;
  sc_gate_resize_backward_kernel<<<(unsigned)((small + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(dx), static_cast<float*>(dk2), small, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
