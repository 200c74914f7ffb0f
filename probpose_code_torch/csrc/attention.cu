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
// Layout of the work: one block per (query tile of 32, head, image); 4 warps
// of 8 queries each. K and V stream through shared memory in tiles of 32
// keys, one key per lane, so any N works; the head width D is covered in
// chunks of 128 output dims. Two passes over the keys: pass 1 finds each
// row's maximum and sum (a running maximum whose sum is rescaled when the
// maximum moves, then combined across the warp); pass 2 recomputes each
// score, forms p = exp(s - m) / l, rounds it to T exactly where the TPU
// kernel rounds it, and accumulates p v in f32. A one-pass (online) softmax
// would round p at other points.
//
// What bounds it: at the ViTPose-B training shape (64 images, N = 192,
// 12 heads, d = 64, f32) it is 7.25 GFLOP (QK^T and PV) against 151 MB of
// inputs and outputs, so operations bound it: 0.108 ms at 67 TFLOP/s f32,
// against 0.045 ms for the bytes at 3.35 TB/s. This first version runs on
// the FMA units from shared memory (16-byte reads, a padded K tile so a
// warp's reads hit distinct banks) and computes the scores twice; tensor
// cores (mma.sync / wgmma) and keeping the scores of a tile in registers
// between the two passes are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int WARPS = 4, QPW = 8, QT = WARPS * QPW;  // queries per block
constexpr int KT = 32;                               // keys per tile, one per lane
constexpr int DC = 128;                              // output dims per pass-2 chunk
constexpr int SMEM_LIMIT = 232448;                   // one block's shared memory on sm_90

struct Layout {
  int dq;  // q row stride in shared memory: D rounded up to 4
  int dk;  // K row stride: dq + 4, so 16-byte reads of 8 lanes hit distinct banks
  int vw;  // V row stride: min(dq, DC)
};

__host__ __device__ inline Layout layout(int D) {
  Layout s;
  s.dq = (D + 3) & ~3;
  s.dk = s.dq + 4;
  s.vw = s.dq < DC ? s.dq : DC;
  return s;
}

size_t smem_bytes(int D) {
  const Layout s = layout(D);
  return sizeof(float) * ((size_t)QT * s.dq + (size_t)KT * s.dk + (size_t)KT * s.vw +
                          (size_t)QT * KT);
}

// s[qq] = q'[qq] . k over the padded width (pad columns are zero)
__device__ __forceinline__ void row_scores(const float* __restrict__ qw, const float* __restrict__ kr,
                                           int dq, float s[QPW]) {
#pragma unroll
  for (int qq = 0; qq < QPW; ++qq) s[qq] = 0.f;
  for (int d = 0; d < dq; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + qq * dq + d);
      s[qq] = fmaf(qv.x, kv.x, s[qq]);
      s[qq] = fmaf(qv.y, kv.y, s[qq]);
      s[qq] = fmaf(qv.z, kv.z, s[qq]);
      s[qq] = fmaf(qv.w, kv.w, s[qq]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_keys(float* __restrict__ ks, const T* __restrict__ kb,
                                          long long ksn, int k0, int N, int D, const Layout& s) {
  for (int i = threadIdx.x; i < KT * s.dq; i += WARPS * 32) {
    const int kj = i / s.dq, d = i % s.dq, n = k0 + kj;
    ks[kj * s.dk + d] = (n < N && d < D) ? to_f(kb[(long long)n * ksn + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, long long qsb, long long qsn, long long qsh, long long ksb,
           long long ksn, long long ksh, long long vsb, long long vsn, long long vsh, int N,
           int H, int D, float scale) {
  extern __shared__ float4 smem4[];
  const Layout L = layout(D);
  float* qs = reinterpret_cast<float*>(smem4);  // QT x dq, pre-scaled q
  float* ks = qs + QT * L.dq;                   // KT x dk
  float* vs = ks + KT * L.dk;                   // KT x vw
  float* ps = vs + KT * L.vw;                   // QT x KT, the rounded p of a tile

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + (long long)b * qsb + (long long)h * qsh;
  const T* kb = k + (long long)b * ksb + (long long)h * ksh;
  const T* vb = v + (long long)b * vsb + (long long)h * vsh;

  // q * scale, both in T (attention.py:60)
  const float sc = to_f(from_f<T>(scale));
  for (int i = tid; i < QT * L.dq; i += WARPS * 32) {
    const int qi = i / L.dq, d = i % L.dq, n = q0 + qi;
    qs[i] = (n < N && d < D) ? to_f(from_f<T>(to_f(qb[(long long)n * qsn + d]) * sc)) : 0.f;
  }
  const float* qw = qs + warp * QPW * L.dq;

  // pass 1: each lane's running maximum and sum over its keys
  float m[QPW], l[QPW], s[QPW];
#pragma unroll
  for (int qq = 0; qq < QPW; ++qq) {
    m[qq] = -INFINITY;
    l[qq] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();
    load_keys(ks, kb, ksn, k0, N, D, L);
    __syncthreads();
    if (k0 + lane < N) {
      row_scores(qw, ks + lane * L.dk, L.dq, s);
#pragma unroll
      for (int qq = 0; qq < QPW; ++qq) {
        if (s[qq] > m[qq]) {
          l[qq] = l[qq] * expf(m[qq] - s[qq]) + 1.f;
          m[qq] = s[qq];
        } else {
          l[qq] += expf(s[qq] - m[qq]);
        }
      }
    }
  }
  // combine across the warp; the butterfly leaves every lane the same (m, l)
#pragma unroll
  for (int qq = 0; qq < QPW; ++qq) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[qq], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[qq], o);
      const float mm = fmaxf(m[qq], m2);
      const float a = m[qq] == -INFINITY ? 0.f : l[qq] * expf(m[qq] - mm);
      const float c = m2 == -INFINITY ? 0.f : l2 * expf(m2 - mm);
      m[qq] = mm;
      l[qq] = a + c;
    }
  }

  // pass 2: p = exp(s - m) / l rounded to T, then p v in f32
  for (int dc0 = 0; dc0 < D; dc0 += DC) {
    const int dcn = min(DC, D - dc0);
    float acc[QPW][DC / 32];
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq)
#pragma unroll
      for (int c = 0; c < DC / 32; ++c) acc[qq][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += KT) {
      __syncthreads();
      load_keys(ks, kb, ksn, k0, N, D, L);
      for (int i = tid; i < KT * dcn; i += WARPS * 32) {
        const int kj = i / dcn, d = i % dcn, n = k0 + kj;
        vs[kj * L.vw + d] = n < N ? to_f(vb[(long long)n * vsn + dc0 + d]) : 0.f;
      }
      __syncthreads();
      const bool real = k0 + lane < N;
      if (real) row_scores(qw, ks + lane * L.dk, L.dq, s);
#pragma unroll
      for (int qq = 0; qq < QPW; ++qq) {
        const float p = real ? to_f(from_f<T>(expf(s[qq] - m[qq]) / l[qq])) : 0.f;
        ps[(warp * QPW + qq) * KT + lane] = p;
      }
      __syncwarp();
      const int kn = min(KT, N - k0);
      for (int kj = 0; kj < kn; ++kj) {
#pragma unroll
        for (int c = 0; c < DC / 32; ++c) {
          if (32 * c >= dcn) break;
          const float vv = lane + 32 * c < dcn ? vs[kj * L.vw + lane + 32 * c] : 0.f;
#pragma unroll
          for (int qq = 0; qq < QPW; ++qq)
            acc[qq][c] = fmaf(ps[(warp * QPW + qq) * KT + kj], vv, acc[qq][c]);
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) {
      const int n = q0 + warp * QPW + qq;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < DC / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < dcn) out[(((long long)b * N + n) * H + h) * D + dc0 + d] = from_f<T>(acc[qq][c]);
      }
    }
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
        int N, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + QT - 1) / QT, H, B);
  mha_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], N,
      H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest head width whose tiles fit in one block's shared memory.
int attention_max_head_dim() {
  int D = 4;
  while (smem_bytes(D + 4) <= SMEM_LIMIT) D += 4;
  return D;
}

const char* attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). strides: the image,
// token and head strides of q, then k, then v, in elements (d is contiguous).
// out is (B, N, H, D) contiguous. Returns 0 or the CUDA error code of the
// launch.
int attention_forward(int dtype, const void* q, const void* k, const void* v, void* out,
                      const long long* strides, int B, int N, int H, int D, float scale,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(q, k, v, out, strides, B, N, H, D, scale, s);
  return run<__nv_bfloat16>(q, k, v, out, strides, B, N, H, D, scale, s);
}

}  // extern "C"
