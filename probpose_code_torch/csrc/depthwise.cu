// MobileNetV2's depthwise 3x3 convolutions as hand-written CUDA for Hopper
// (sm_90a): the forward, the input's gradient and the weight's gradient, f32,
// padding 1, stride 1 or 2, on channels-last (NHWC) activations.
//
// It replaces no TPU kernel: the JAX package's MobileNetV2
// (probpose_code_tpu/models/backbones/mobilenet_v2.py:45-47) runs them
// through XLA's grouped convolution. On the card cuDNN's depthwise kernels
// took 3.42% of the hand recipe's step (its 17 depthwise convolutions,
// forward and both gradients, at B = 64, 256 x 256; H100 80GB HBM3, 700 W),
// over the 2% bar, so they are kernels here with their plain twin beside
// them (probpose_code_torch/ops/kernels/depthwise.py: F.conv2d with one group
// a channel).
//
// Every call is bound by memory: 9 multiply-adds a value read. The channel
// counts are multiples of 4 (every MobileNetV2 width is a multiple of 8) and
// the rows 16-byte aligned, so a thread takes four channels (float4 loads:
// a warp's loads are 512 contiguous bytes) and a run of XR = 8 outputs along
// a row, whose input columns it loads once a kernel row, each serving the
// (up to 3 / S) outputs that read it. The stride S is a template argument;
// a thread divides by runtime sizes once.
//
// depthwise_forward4_kernel<S, FLIP>: a run's outputs, the taps in
// registers; with FLIP the taps reversed, which makes the stride-1 input
// gradient the same correlation of the output's gradient.
// depthwise_dgrad2_kernel: the stride-2 input gradient, each input gathering
// from the (at most four) outputs its taps reach, a block a row.
// depthwise_wgrad4_kernel<S>: the weight's gradient, a sum over every output
// position: a thread a run over WG_ROWS output rows, nine float4 sums in
// registers, written as one partial row; depthwise_wgrad_reduce sums the
// partials in fixed segments of RED rows, then depthwise_wgrad_final the
// segments in float64, each in order. No atomics: the result repeats bit for
// bit.
//
// The designs tried (chip_smoke.py's face_hand_kernels on an H100 80GB HBM3
// at 700 W; the 17 convolutions of a B = 64 step, forward / backward, beside
// cuDNN's in the same run, about 0.77 / 3.18 ms): every element indexed by
// 64-bit divisions, 2.39 / 16.38 ms; a block a row, 1.34 / 3.92; tiles
// staged in shared memory, 1.47 / 3.52; the float4 runs for the forward and
// the stride-1 input gradient, the weight gradient still in staged tiles
// (1.8 ms of it), 0.99 / 3.20; the float4 runs for the weight gradient too,
// 0.99 / 2.89.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_C = 32;   // channels of a stride-2 input-gradient block (x 8 lanes)
constexpr int XR = 8;        // outputs of a thread's run along a row
constexpr int WG_ROWS = 16;  // output rows a weight-gradient thread sums
constexpr int RED = 64;      // partial rows a first-level reduction thread sums

struct Shape {
  int n, C, H, W, Ho, Wo;  // the source n x H x W x C, the result n x Ho x Wo x C
};

__device__ __forceinline__ void fma4(float4& acc, const float4& a, const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// src: n x H x W x C; dst: n x Ho x Wo x C (for the stride-1 input gradient src is dy, dst dx).
template <int S, bool FLIP>
__global__ void __launch_bounds__(THREADS) depthwise_forward4_kernel(const float* __restrict__ src,
                                                                     const float* __restrict__ w,
                                                                     float* __restrict__ dst, Shape s,
                                                                     int runs) {
  const int quads = s.C / 4;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int q = (int)(t % quads);
  long long rest = t / quads;
  const int run = (int)(rest % runs);
  rest /= runs;
  const int yo = (int)(rest % s.Ho);
  const long long n = rest / s.Ho;
  if (n >= s.n) return;
  float4 taps[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int tap = FLIP ? 8 - k : k;
    taps[k] = make_float4(__ldg(w + (4 * q) * 9 + tap), __ldg(w + (4 * q + 1) * 9 + tap),
                          __ldg(w + (4 * q + 2) * 9 + tap), __ldg(w + (4 * q + 3) * 9 + tap));
  }
  const int xo0 = run * XR;
  float4 acc[XR];
#pragma unroll
  for (int j = 0; j < XR; ++j) acc[j] = zero4();
  const float4* img = reinterpret_cast<const float4*>(src) + n * s.H * s.W * quads + q;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int yi = yo * S - 1 + ky;
    if (yi < 0 || yi >= s.H) continue;
    const float4* line = img + (long long)yi * s.W * quads;
    // input columns xo0 S - 1 ... (xo0 + XR - 1) S + 1 of this row
#pragma unroll
    for (int col = 0; col < (XR - 1) * S + 3; ++col) {
      const int xi = xo0 * S - 1 + col;
      const float4 v = (xi >= 0 && xi < s.W) ? __ldg(line + xi * quads) : zero4();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // the output j whose tap kx reads this column: j S + kx = col
        if ((col - kx) % S == 0 && col - kx >= 0 && (col - kx) / S < XR) fma4(acc[(col - kx) / S], v, taps[ky * 3 + kx]);
      }
    }
  }
  float4* out = reinterpret_cast<float4*>(dst) + (n * s.Ho + yo) * s.Wo * quads + q;
#pragma unroll
  for (int j = 0; j < XR; ++j) {
    if (xo0 + j < s.Wo) out[(xo0 + j) * quads] = acc[j];
  }
}

// The stride-2 input gradient: dy n x Ho x Wo x C -> dx n x H x W x C, a block a row of dx.
__global__ void __launch_bounds__(THREADS) depthwise_dgrad2_kernel(const float* __restrict__ dy,
                                                                   const float* __restrict__ w,
                                                                   float* __restrict__ dx, Shape s) {
  const int row = blockIdx.x;  // n * H + yi
  const int n = row / s.H, yi = row - n * s.H;
  const int c = blockIdx.y * TILE_C + threadIdx.x % TILE_C;
  const int lane = threadIdx.x / TILE_C;
  if (c >= s.C) return;
  float taps[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) taps[t] = __ldg(w + c * 9 + t);
  const float* grad = dy + (size_t)n * s.Ho * s.Wo * s.C + c;
  float* out = dx + (size_t)row * s.W * s.C + c;
  for (int xi = lane; xi < s.W; xi += THREADS / TILE_C) {
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int t = yi + 1 - ky;  // 2 yo
      if (t < 0 || (t & 1)) continue;
      const int yo = t >> 1;
      if (yo >= s.Ho) continue;
      const float* line = grad + (size_t)yo * s.Wo * s.C;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int u = xi + 1 - kx;  // 2 xo
        if (u < 0 || (u & 1)) continue;
        const int xo = u >> 1;
        if (xo >= s.Wo) continue;
        acc = fmaf(__ldg(line + xo * s.C), taps[ky * 3 + kx], acc);
      }
    }
    out[xi * s.C] = acc;
  }
}

// x: n x H x W x C, dy: n x Ho x Wo x C -> partial[(chunk runs + run)][C][9], a thread's four channels over
// its run of a chunk of WG_ROWS output rows.
template <int S>
__global__ void __launch_bounds__(THREADS) depthwise_wgrad4_kernel(const float* __restrict__ x,
                                                                   const float* __restrict__ dy,
                                                                   float* __restrict__ partial, Shape s, int runs,
                                                                   int chunks) {
  const int quads = s.C / 4;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int q = (int)(t % quads);
  long long rest = t / quads;
  const int run = (int)(rest % runs);
  const long long chunk = rest / runs;
  if (chunk >= chunks) return;
  float4 acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = zero4();
  const int xo0 = run * XR;
  const int rows = s.n * s.Ho;
  const int last = min((int)(chunk + 1) * WG_ROWS, rows);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* dy4 = reinterpret_cast<const float4*>(dy);
  for (int row = (int)chunk * WG_ROWS; row < last; ++row) {  // n Ho + yo
    const int n = row / s.Ho, yo = row - n * s.Ho;
    const float4* grad = dy4 + (long long)row * s.Wo * quads + q;
    float4 g[XR];
#pragma unroll
    for (int j = 0; j < XR; ++j) g[j] = xo0 + j < s.Wo ? __ldg(grad + (xo0 + j) * quads) : zero4();
    const float4* img = x4 + (long long)n * s.H * s.W * quads + q;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yi = yo * S - 1 + ky;
      if (yi < 0 || yi >= s.H) continue;
      const float4* line = img + (long long)yi * s.W * quads;
#pragma unroll
      for (int col = 0; col < (XR - 1) * S + 3; ++col) {
        const int xi = xo0 * S - 1 + col;
        const float4 v = (xi >= 0 && xi < s.W) ? __ldg(line + xi * quads) : zero4();
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          if ((col - kx) % S == 0 && col - kx >= 0 && (col - kx) / S < XR) {
            fma4(acc[ky * 3 + kx], g[(col - kx) / S], v);
          }
        }
      }
    }
  }
  float* out = partial + ((chunk * runs + run) * s.C + 4 * q) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    out[k] = acc[k].x;
    out[9 + k] = acc[k].y;
    out[18 + k] = acc[k].z;
    out[27 + k] = acc[k].w;
  }
}

// partial rows [segment RED, segment RED + RED) of entry i (C x 9 entries a row), summed in order
__global__ void depthwise_wgrad_reduce(const float* __restrict__ partial, float* __restrict__ mid, int entries,
                                       int rows) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= entries) return;
  const int first = blockIdx.y * RED, last = min(first + RED, rows);
  float sum = 0.f;
  for (int r = first; r < last; ++r) sum += partial[(size_t)r * entries + i];
  mid[(size_t)blockIdx.y * entries + i] = sum;
}

__global__ void depthwise_wgrad_final(const float* __restrict__ mid, float* __restrict__ dw, int entries,
                                      int segments) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= entries) return;
  double sum = 0.0;
  for (int k = 0; k < segments; ++k) sum += mid[(size_t)k * entries + i];
  dw[i] = (float)sum;
}

// depthwise_forward4_kernel over src n x H x W x C into dst n x Ho x Wo x C.
void forward4(const float* src, const float* w, float* dst, int n, int C, int H, int W, int Ho, int Wo, int stride,
              bool flip, cudaStream_t st) {
  const int runs = (Wo + XR - 1) / XR;
  const Shape s{n, C, H, W, Ho, Wo};
  const unsigned blocks = (unsigned)(((long long)n * Ho * runs * (C / 4) + THREADS - 1) / THREADS);
  if (stride == 1 && flip) {
    depthwise_forward4_kernel<1, true><<<blocks, THREADS, 0, st>>>(src, w, dst, s, runs);
  } else if (stride == 1) {
    depthwise_forward4_kernel<1, false><<<blocks, THREADS, 0, st>>>(src, w, dst, s, runs);
  } else {
    depthwise_forward4_kernel<2, false><<<blocks, THREADS, 0, st>>>(src, w, dst, s, runs);
  }
}

// The weight gradient's partial rows (chunks of WG_ROWS output rows times runs) and their segments of RED.
void wgrad_sizes(int n, int Ho, int Wo, int* rows, int* segments) {
  const int chunks = (n * Ho + WG_ROWS - 1) / WG_ROWS;
  *rows = chunks * ((Wo + XR - 1) / XR);
  *segments = (*rows + RED - 1) / RED;
}

}  // namespace

extern "C" {

const char* depthwise_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The floats of the weight gradient's scratch buffer: its partial rows and segments of C x 9 entries.
long long depthwise_scratch(int n, int C, int Ho, int Wo) {
  int rows, segments;
  wgrad_sizes(n, Ho, Wo, &rows, &segments);
  return (long long)(rows + segments) * C * 9;
}

// x: n x H x W x C floats (channels last, C a multiple of 4, 16-byte aligned), w: C x 3 x 3, y: n x Ho x Wo x C;
// each tensor under 2^31 elements.
int depthwise_forward(const void* x, const void* w, void* y, int n, int C, int H, int W, int Ho, int Wo, int stride,
                      void* stream) {
  if (n <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return 0;
  forward4(static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), n, C, H, W, Ho, Wo,
           stride, false, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// dy: n x Ho x Wo x C, x: n x H x W x C, w: C x 3 x 3; dx: n x H x W x C, dw: C x 3 x 3; scratch: the
// depthwise_scratch(n, C, Ho, Wo) floats.
int depthwise_backward(const void* dy, const void* x, const void* w, void* dx, void* dw, void* scratch, int n, int C,
                       int H, int W, int Ho, int Wo, int stride, void* stream) {
  if (n <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dy);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const Shape s{n, C, H, W, Ho, Wo};
  if (stride == 1) {  // the input's gradient: the correlation of dy with the reversed taps (H x W = Ho x Wo)
    forward4(g, wp, static_cast<float*>(dx), n, C, Ho, Wo, H, W, 1, true, st);
  } else {
    depthwise_dgrad2_kernel<<<dim3((unsigned)(n * H), (unsigned)((C + TILE_C - 1) / TILE_C)), THREADS, 0, st>>>(
        g, wp, static_cast<float*>(dx), s);
  }
  int rows, segments;
  wgrad_sizes(n, Ho, Wo, &rows, &segments);
  const int runs = (Wo + XR - 1) / XR, chunks = rows / runs, entries = C * 9;
  float* partial = static_cast<float*>(scratch);
  float* mid = partial + (size_t)rows * entries;
  const unsigned blocks = (unsigned)(((long long)rows * (C / 4) + THREADS - 1) / THREADS);
  if (stride == 1) {
    depthwise_wgrad4_kernel<1><<<blocks, THREADS, 0, st>>>(xp, g, partial, s, runs, chunks);
  } else {
    depthwise_wgrad4_kernel<2><<<blocks, THREADS, 0, st>>>(xp, g, partial, s, runs, chunks);
  }
  const unsigned cols = (unsigned)((entries + THREADS - 1) / THREADS);
  depthwise_wgrad_reduce<<<dim3(cols, (unsigned)segments), THREADS, 0, st>>>(partial, mid, entries, rows);
  depthwise_wgrad_final<<<cols, THREADS, 0, st>>>(mid, static_cast<float*>(dw), entries, segments);
  return (int)cudaGetLastError();
}

}  // extern "C"
