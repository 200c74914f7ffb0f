// ResNeSt's split attention, its radix softmax and weighted sum, forward
// and backward, as hand-written CUDA for Hopper (sm_90a), f32:
//   out[b, c, p] = sum_r splits[b, r, c, p] att[b, r, c],
//   att[b, :, c] = softmax over r of logits[b, :, c] (sigmoid at radix 1),
// splits (B, R, C, P) with P = H W, logits (B, R, C).
//
// It replaces no TPU kernel: the JAX package computes it with XLA's softmax,
// product and sum (probpose_code_tpu/models/backbones/litehrnet.py:245-247).
// In PyTorch (probpose_code_torch/ops/kernels/split_attention.py:
// split_attention_plain, its plain twin) the weighted sum writes the R
// weighted splits before it sums them, and its backward writes the
// products dy * splits before it sums them over space; over ResNeSt-50's
// training step at B = 64 it passed the 2% bar. Here:
//
// split_attention_forward_kernel: one block a (b, c) plane, its R weights
// computed by each thread in registers from the logits (R <= 4), the plane
// read and written 16 bytes a thread where its size allows (a first design,
// one thread an element of the whole output with 64-bit index divisions,
// ran 3.6x its bound, slower than the twin). Reads the R splits, writes
// out: 4 (R + 1) bytes an element, memory-bound.
// split_attention_backward_kernel: one block a (b, c) plane. Each thread
// walks its elements of the plane: d_splits[r] = dy att[r], and the R dot
// products dy . splits[r] summed in registers, then over the block in a
// fixed tree (deterministic). Thread 0 turns them into the logits'
// gradient (the softmax's Jacobian). Reads dy and the R splits, writes the
// R gradients: 4 (2 R + 1) bytes an element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_RADIX = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ void weights(const float* __restrict__ logits, long long b, int c, int R, int C,
                                        float* att) {
  const float* l = logits + b * R * C + c;
  if (R == 1) {
    att[0] = 1.f / (1.f + expf(-__ldg(l)));
    return;
  }
  float m = __ldg(l);
  for (int r = 1; r < R; ++r) m = fmaxf(m, __ldg(l + r * C));
  float sum = 0.f;
  for (int r = 0; r < R; ++r) {
    att[r] = expf(__ldg(l + r * C) - m);
    sum += att[r];
  }
  for (int r = 0; r < R; ++r) att[r] /= sum;
}

__global__ void split_attention_forward_kernel(const float* __restrict__ splits, const float* __restrict__ logits,
                                               float* __restrict__ out, int R, int C, int P, bool vec) {
  const long long plane = blockIdx.x;
  const long long b = plane / C;
  const int c = (int)(plane - b * C);
  float att[MAX_RADIX];
  weights(logits, b, c, R, C, att);
  const float* s = splits + (b * R * C + c) * P;  // split r at s + r C P
  const long long stride = (long long)C * P;
  float* o = out + plane * P;
  if (vec) {  // P a multiple of 4, every plane 16-byte aligned
    for (int q = threadIdx.x; q < P / 4; q += blockDim.x) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < R; ++r) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(s + r * stride) + q);
        acc.x += v.x * att[r];
        acc.y += v.y * att[r];
        acc.z += v.z * att[r];
        acc.w += v.w * att[r];
      }
      reinterpret_cast<float4*>(o)[q] = acc;
    }
    return;
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) acc += __ldg(s + r * stride + p) * att[r];
    o[p] = acc;
  }
}

__global__ void split_attention_backward_kernel(const float* __restrict__ dy, const float* __restrict__ splits,
                                                const float* __restrict__ logits, float* __restrict__ dsplits,
                                                float* __restrict__ dlogits, int R, int C, int P) {
  const long long plane = blockIdx.x;
  const long long b = plane / C;
  const int c = (int)(plane - b * C);
  float att[MAX_RADIX];
  weights(logits, b, c, R, C, att);
  float dot[MAX_RADIX] = {0.f, 0.f, 0.f, 0.f};
  const float* g = dy + plane * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float gp = __ldg(g + p);
    for (int r = 0; r < R; ++r) {
      const long long at = ((b * R + r) * C + c) * P + p;
      dot[r] += gp * __ldg(splits + at);
      dsplits[at] = gp * att[r];
    }
  }
  __shared__ float sums[MAX_RADIX][THREADS];
  for (int r = 0; r < R; ++r) sums[r][threadIdx.x] = dot[r];
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      for (int r = 0; r < R; ++r) sums[r][threadIdx.x] += sums[r][threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  float* dl = dlogits + b * R * C + c;
  if (R == 1) {
    dl[0] = sums[0][0] * att[0] * (1.f - att[0]);
    return;
  }
  float mean = 0.f;
  for (int r = 0; r < R; ++r) mean += att[r] * sums[r][0];
  for (int r = 0; r < R; ++r) dl[r * C] = att[r] * (sums[r][0] - mean);
}

// a power of two from 32 to THREADS, about the plane's size
int threads_for(int P) {
  int t = 32;
  while (t < THREADS && t < P) t *= 2;
  return t;
}

}  // namespace

extern "C" {

const char* split_attention_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// splits: B x R x C x P floats; logits: B x R x C; out: B x C x P.
int split_attention_forward(const void* splits, const void* logits, void* out, int B, int R, int C, int P,
                            void* stream) {
  if ((long long)B * C * P <= 0) return 0;
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(splits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  split_attention_forward_kernel<<<(unsigned)((long long)B * C), threads_for(vec ? P / 4 : P), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(splits), static_cast<const float*>(logits), static_cast<float*>(out), R, C, P, vec);
  return (int)cudaGetLastError();
}

// dy: B x C x P; dsplits as splits; dlogits as logits.
int split_attention_backward(const void* dy, const void* splits, const void* logits, void* dsplits, void* dlogits,
                             int B, int R, int C, int P, void* stream) {
  if ((long long)B * C * P <= 0) return 0;
  split_attention_backward_kernel<<<(unsigned)((long long)B * C), threads_for(P), 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(splits), static_cast<const float*>(logits),
      static_cast<float*>(dsplits), static_cast<float*>(dlogits), R, C, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
