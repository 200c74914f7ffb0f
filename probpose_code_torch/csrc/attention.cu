// The attention core of a ViT layer, as hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel probpose_code_tpu/ops/pallas/attention.py:
// fused_attention (_mha_kernel). Per image b and head h it computes exactly
// that kernel's math:
//
//   q'  = round_T(q * round_T(scale))   the q-scale in q's type T
//   s   = q' k^T                        f32 accumulation
//   p   = exp(s - max(s)) / sum         max-shifted softmax in f32,
//                                       then rounded to T
//   out = round_T(p v)                  f32 accumulation
//
// T is float or bf16. q, k and v are read in place from strided views (the
// (B, N, 3, h, d) qkv projection in the ViT block): each has its own image,
// token and head strides, with d contiguous. The output is (B, N, h, d)
// contiguous, which is (B, N, C). The TPU kernel's transposes to (B*h, N, d)
// blocks become index arithmetic.
//
// What bounds it: at the ViTPose-B training shape (64 images, N = 192,
// 12 heads, d = 64, f32) it is 7.25 GFLOP (QK^T and PV) against 151 MB of
// inputs and outputs: 0.044 ms of f32-accurate products at the 165 TFLOP/s
// that 3xTF32 leaves of the tensor cores' 495 TF32, against 0.045 ms for the
// bytes at 3.35 TB/s, so it is about even. What the design does about it:
// both products run on the tensor cores through the attention engine of
// tc_tiles.cuh, bf16 as mma.sync m16n8k16 and f32 as 3xTF32 m16n8k8 (the f32
// bar, 1e-4 absolute on unit-normal inputs, rules out single-pass TF32). At
// N <= 192 (the 256x192 crops) a head's K and V sit whole in shared memory
// and each warp keeps its 16 queries' key row in registers: each score is
// computed once, the row maximum is taken from the registers, and p is
// rounded after the division as the TPU kernel rounds it (an online softmax
// would round it elsewhere). That one pass takes heads up to 64 wide in
// bf16 and f32, and in f32 also heads up to 96 wide (ViTPose-H's 80): one
// block of 12 warps holds a head's 192 queries and reads its K and V once,
// and the output is taken 48 columns at a time from the same p, so that the
// accumulators fit beside the key row in the registers of one block an SM.
// Elsewhere (longer rows, wider heads), two passes over key chunks through
// shared memory: a running maximum and sum, then p v, the scores recomputed
// for each 64 output columns. attention_occupancy reads what the chosen
// instance holds on an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tiles.cuh"

namespace {

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, const long long* st, int B, int N, int H, int D,
        float scale, cudaStream_t stream) {
  constexpr int CH = 16 / sizeof(T);
  tc::Heads<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  bool vec = true;
  for (int i = 0; i < 3; ++i) {
    a.sb[i] = st[3 * i];
    a.sn[i] = st[3 * i + 1];
    a.sh[i] = st[3 * i + 2];
    vec = vec && a.sb[i] % CH == 0 && a.sn[i] % CH == 0 && a.sh[i] % CH == 0;
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  vec = vec && bases % 16 == 0;
  a.out = static_cast<T*>(out);
  a.scale = scale;
  a.N = N;
  a.H = H;
  a.D = D;
  a.vec = vec;
  return (int)tc::attention_heads<T, true>(a, B, stream);
}

}  // namespace

extern "C" {

// Why heads D wide cannot run, or NULL. dtype as below.
const char* attention_shape_error(int dtype, int D) {
  return dtype == 0 ? tc::attention_shape_error<float>(D) : tc::attention_shape_error<__nv_bfloat16>(D);
}

// What the instance that N keys of heads D wide launch holds on an SM, into
// out[5]: registers a thread, local memory a thread (spills), dynamic shared
// memory a block, threads a block and blocks resident an SM. dtype as below;
// shift 1: K4's instance (a max-shifted softmax), 0: K1's (vit_layer.cu,
// exp(min(s, 80))). Returns 0 or the CUDA error code.
int attention_occupancy(int dtype, int shift, int N, int D, int* out) {
  if (dtype == 0)
    return (int)(shift ? tc::attention_occupancy<float, true>(N, D, out)
                       : tc::attention_occupancy<float, false>(N, D, out));
  return (int)(shift ? tc::attention_occupancy<__nv_bfloat16, true>(N, D, out)
                     : tc::attention_occupancy<__nv_bfloat16, false>(N, D, out));
}

const char* attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). strides: the image,
// token and head strides of q, then k, then v, in elements (d is contiguous).
// out is (B, N, H, D) contiguous. The caller checks attention_shape_error
// first. Returns 0 or the CUDA error code of the launch.
int attention_forward(int dtype, const void* q, const void* k, const void* v, void* out,
                      const long long* strides, int B, int N, int H, int D, float scale,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(q, k, v, out, strides, B, N, H, D, scale, s);
  return run<__nv_bfloat16>(q, k, v, out, strides, B, N, H, D, scale, s);
}

}  // extern "C"
