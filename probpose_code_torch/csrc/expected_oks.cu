// Expected-OKS heatmap decode as hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernels probpose_code_tpu/ops/pallas/expected_oks.py:
// heatmap_expected_value_pallas_fused (_fused_decode_kernel) and, through
// the conv-only entry, oks_convolve_pallas (_conv_kernel).
//
// One block of six warps per (b, k) heatmap:
//   - the fill: the H x W map comes in with 16-byte loads where its rows
//     allow (48 floats are 12 of them), four in flight a thread, and lands
//     in shared memory between the R-wide reflected ("symmetric") borders,
//     which are then copied from their mirrored columns there; no padded
//     copy is written to device memory and no index is divided per element;
//   - the separable OKS filter, a pass along W and then one along H, with
//     the keypoint's 1-D factor (the band of the banded operators that the
//     TPU kernel multiplies by). Each thread filters a strip of 16
//     consecutive outputs along the filtered axis and slides one window of
//     16 + D - 1 inputs through them, so a tap is a register (D is a
//     template parameter) and a shared load feeds 16 multiply-adds at most;
//     the W pass writes each row also into the reflected rows of the H
//     pass's padded buffer, so neither pass reflects an index;
//   - the argmax: each H strip's largest output and first row by selects,
//     then the thread's, the warp's by shuffles on (value, index) and one
//     warp over the six partials, always the first index on ties; the
//     filtered map is never stored: five lanes recompute the five values
//     that the Taylor step reads, in the H pass's order, so they are the
//     same bits;
//   - the 1-D Taylor shift with the border guard and the 1e-6 guard for zero
//     curvature, and the raw heatmap value at the integer peak as the score.
// The locations come out already scaled to the model input.
//
// What bounds it: at B = 64, K = 17, 64 x 48 the decode reads 13.4 MB of
// heatmaps and writes 13 KB (4.0 us at 3.35 TB/s); its two passes are 19
// multiply-adds per output each over the H x W map, 0.254 GFLOP of f32 (3.8
// us at 67 TFLOP/s outside the tensor cores). The tensor cores stay out:
// the banded products would be about 1 MFLOP a map, and single-pass TF32
// would put the argmax decision at risk. Shared-memory pitches are odd, so
// the W pass (lanes over rows) and the H pass (lanes over columns, a warp
// spanning two strips 16 rows apart when W is 48) hit 32 distinct banks.
// The flagship shape takes 33.2 KB of shared memory a block; larger maps opt
// into more dynamic shared memory.
//
// Instances: the taps in registers for D = 19 (64 x 48, 128 x 96), 15 and 5
// (32 x 24 at 17 and 4 keypoints); any other odd D <= 64 runs the same code
// with D a runtime value and the taps in shared memory. The entry chooses
// the instance by D before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 192;
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 16;
constexpr int FILL = 4;  // float4 loads a thread keeps in flight in the fill
constexpr int MAX_TAPS = 64;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The map buffer: H rows of R + W + R columns plus the last strip's overrun.
// The W-pass buffer: the H pass's padded rows plus its last strip's overrun.
// Both pitches odd.
__host__ __device__ inline int map_pitch(int W, int R) { return (round_up(W, STRIP) + 2 * R) | 1; }
__host__ __device__ inline int wbuf_pitch(int W) { return W | 1; }
__host__ __device__ inline int wbuf_rows(int H, int R) { return round_up(H, STRIP) + 2 * R; }

size_t smem_bytes(int H, int W, int R) {
  return sizeof(float) * ((size_t)H * map_pitch(W, R) + (size_t)wbuf_rows(H, R) * wbuf_pitch(W));
}

__device__ __forceinline__ int reflect(int i, int n) {
  // numpy/jnp.pad mode="symmetric" for a pad no wider than n
  if (i < 0) return -i - 1;
  if (i >= n) return 2 * n - 1 - i;
  return i;
}

// The keypoint's taps: registers for a compile-time D, shared memory otherwise.
template <int DT>
struct Taps {
  float v[DT];
  __device__ __forceinline__ float operator[](int t) const { return v[t]; }
};

template <>
struct Taps<0> {
  const float* v;
  __device__ __forceinline__ float operator[](int t) const { return v[t]; }
};

// acc[j] = sum_t tap[t] * in[(j + t) * stride] for the strip's 16 outputs,
// each summed from 0 in increasing t with fmaf: the order of a plain loop
// over the taps, so the bits do not depend on the strip.
template <int DT>
__device__ __forceinline__ void filter_strip(const Taps<DT>& tap, int D, const float* in, int stride,
                                             float (&acc)[STRIP]) {
#pragma unroll
  for (int j = 0; j < STRIP; ++j) acc[j] = 0.f;
  if constexpr (DT > 0) {
#pragma unroll
    for (int i = 0; i < STRIP + DT - 1; ++i) {
      const float x = in[i * stride];
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        const int t = i - j;
        if (t >= 0 && t < DT) acc[j] = fmaf(tap[t], x, acc[j]);
      }
    }
  } else {
    for (int i = 0; i < STRIP + D - 1; ++i) {
      const float x = in[i * stride];
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        const int t = i - j;
        if (t >= 0 && t < D) acc[j] = fmaf(tap[t], x, acc[j]);
      }
    }
  }
}

// One output of the H pass, summed as filter_strip sums it.
template <int DT>
__device__ __forceinline__ float filter_one(const Taps<DT>& tap, int D, const float* in, int stride) {
  float s = 0.f;
  if constexpr (DT > 0) {
#pragma unroll
    for (int t = 0; t < DT; ++t) s = fmaf(tap[t], in[t * stride], s);
  } else {
    for (int t = 0; t < D; ++t) s = fmaf(tap[t], in[t * stride], s);
  }
  return s;
}

// The largest of a strip's first `rows` outputs and its first j on ties, by
// selects; -1 when none is larger than -inf (NaN never wins).
template <bool FULL_STRIP>
__device__ __forceinline__ void strip_argmax(const float (&acc)[STRIP], int rows, float& sbest, int& sj) {
  sbest = -__int_as_float(0x7f800000);
  sj = -1;
#pragma unroll
  for (int j = 0; j < STRIP; ++j) {
    const bool take = (FULL_STRIP || j < rows) && acc[j] > sbest;
    sbest = take ? acc[j] : sbest;
    sj = take ? j : sj;
  }
}

// The larger (value, index), the first index on ties; NaN never wins.
__device__ __forceinline__ void argmax_warp(float& best, int& bidx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bidx, o);
    if (ov > best || (ov == best && oi < bidx)) {
      best = ov;
      bidx = oi;
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS)
expected_oks_kernel(const float* __restrict__ heatmaps, const float* __restrict__ fk_table,
                    float* __restrict__ locs, float* __restrict__ vals,
                    float* __restrict__ conv_out, int K, int H, int W, int D,
                    float sx, float sy) {
  extern __shared__ float smem[];
  __shared__ float fk[DT > 0 ? 1 : MAX_TAPS];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];

  const int R = D / 2, HW = H * W;
  const int pm = map_pitch(W, R), pw = wbuf_pitch(W);
  float* mpad = smem;           // H x pm: the map between its reflected columns
  float* wbuf = smem + H * pm;  // wbuf_rows x pw: the W pass on the padded rows

  const int map = blockIdx.x;
  const int k = map % K;
  const float* hm = heatmaps + (size_t)map * HW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  Taps<DT> tap;
  if constexpr (DT > 0) {
#pragma unroll
    for (int t = 0; t < DT; ++t) tap.v[t] = __ldg(fk_table + k * DT + t);
  } else {
    for (int t = tid; t < D; t += THREADS) fk[t] = fk_table[k * D + t];
    tap.v = fk;
  }

  // the fill: the interior by rows of float4 where W % 4 == 0 and the maps
  // are 16-byte aligned, with (row, quad) stepped, not divided; a thread's
  // FILL loads are all in flight before its first store
  if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(heatmaps) & 15) == 0) {
    const int wq = W / 4, nq = H * wq;
    const int dr = THREADS / wq, dq = THREADS - dr * wq;
    int r = tid / wq, q = tid - r * wq;
    const float4* src = reinterpret_cast<const float4*>(hm);
    for (int i0 = tid; i0 < nq; i0 += FILL * THREADS) {
      float4 v[FILL];
#pragma unroll
      for (int u = 0; u < FILL; ++u)
        if (i0 + u * THREADS < nq) v[u] = __ldg(src + i0 + u * THREADS);
#pragma unroll
      for (int u = 0; u < FILL; ++u) {
        if (i0 + u * THREADS < nq) {
          float* dst = mpad + r * pm + R + 4 * q;
          dst[0] = v[u].x;
          dst[1] = v[u].y;
          dst[2] = v[u].z;
          dst[3] = v[u].w;
        }
        q += dq;
        r += dr;
        if (q >= wq) {
          q -= wq;
          ++r;
        }
      }
    }
  } else {
    for (int r = warp; r < H; r += WARPS)
      for (int c = lane; c < W; c += 32) mpad[r * pm + R + c] = __ldg(hm + r * W + c);
  }
  __syncthreads();
  // the reflected borders, R columns on each side, copied from their mirrored
  // columns in shared memory; lanes over rows
  for (int e = warp; e < 2 * R; e += WARPS) {
    const int pc = e < R ? e : W + e;
    const int from = R + reflect(pc - R, W);
    for (int r = lane; r < H; r += 32) mpad[r * pm + pc] = mpad[r * pm + from];
  }
  __syncthreads();

  // along W, lanes over rows: padded row R + r, and its mirrors R - 1 - r
  // (r < R) and R + 2H - 1 - r (r >= H - R) in the top and bottom pads
  const int nsw = (W + STRIP - 1) / STRIP;
  for (int item = tid; item < nsw * H; item += THREADS) {
    const int s = item / H, r = item - s * H;
    const int c0 = s * STRIP;
    float acc[STRIP];
    filter_strip<DT>(tap, D, mpad + r * pm + c0, 1, acc);
    const int top = R - 1 - r, bottom = R + 2 * H - 1 - r;
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (c0 + j < W) {
        wbuf[(R + r) * pw + c0 + j] = acc[j];
        if (r < R) wbuf[top * pw + c0 + j] = acc[j];
        if (r >= H - R) wbuf[bottom * pw + c0 + j] = acc[j];
      }
    }
  }
  __syncthreads();

  // along H, lanes over columns; each output goes to the argmax or out
  float best = -__int_as_float(0x7f800000);  // -inf
  int bidx = HW;
  const int nsh = (H + STRIP - 1) / STRIP;
  for (int item = tid; item < nsh * W; item += THREADS) {
    const int s = item / W, c = item - s * W;
    const int r0 = s * STRIP;
    float acc[STRIP];
    filter_strip<DT>(tap, D, wbuf + r0 * pw + c, pw, acc);
    const int rows = min(STRIP, H - r0);
    if (conv_out != nullptr) {
      float* out = conv_out + (size_t)map * HW + r0 * W + c;
      if (rows == STRIP) {
#pragma unroll
        for (int j = 0; j < STRIP; ++j) out[j * W] = acc[j];
      } else {
#pragma unroll
        for (int j = 0; j < STRIP; ++j)
          if (j < rows) out[j * W] = acc[j];
      }
    }
    // the strip's largest value and its first row (rows ascend with j), then
    // the thread's, whose items need not ascend: the first index on ties
    float sbest;
    int sj;
    if (rows == STRIP) {
      strip_argmax<true>(acc, rows, sbest, sj);
    } else {
      strip_argmax<false>(acc, rows, sbest, sj);
    }
    const int idx = (r0 + sj) * W + c;
    if (sj >= 0 && (sbest > best || (sbest == best && idx < bidx))) {
      best = sbest;
      bidx = idx;
    }
  }
  if (locs == nullptr) return;

  argmax_warp(best, bidx);
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < WARPS ? red_v[lane] : -__int_as_float(0x7f800000);
  bidx = lane < WARPS ? red_i[lane] : HW;
  argmax_warp(best, bidx);
  if (bidx >= HW) bidx = 0;  // all-NaN map: jnp.argmax also gives 0 on no max

  const int xi = bidx % W, yi = bidx / W;
  const int xc = min(max(xi, 1), W - 2), yc = min(max(yi, 1), H - 2);
  // lanes 0-4: the filtered map at the centre, left, right, up and down
  float v = 0.f;
  if (lane < 5) {
    const int px = min(max(xc + (lane == 1 ? -1 : lane == 2 ? 1 : 0), 0), W - 1);
    const int py = min(max(yc + (lane == 3 ? -1 : lane == 4 ? 1 : 0), 0), H - 1);
    v = filter_one<DT>(tap, D, wbuf + py * pw + px, pw);
  }
  const float c = __shfl_sync(FULL, v, 0);
  const float left = __shfl_sync(FULL, v, 1), right = __shfl_sync(FULL, v, 2);
  const float up = __shfl_sync(FULL, v, 3), down = __shfl_sync(FULL, v, 4);
  if (lane != 0) return;

  const bool valid = xi > 0 && xi < W - 1 && yi > 0 && yi < H - 1;
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
  vals[map] = mpad[yi * pm + R + xi];
}

template <int DT>
cudaError_t launch(const float* heatmaps, const float* fk, float* locs, float* vals, float* conv_out,
                   int BK, int K, int H, int W, int D, float sx, float sy, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, W, D / 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(expected_oks_kernel<DT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  expected_oks_kernel<DT><<<BK, THREADS, smem, stream>>>(heatmaps, fk, locs, vals, conv_out, K, H, W, D, sx, sy);
  return cudaGetLastError();
}

// The one list of register instances (see the head of the file): the entry
// launches from it and expected_oks_register_taps answers from it.
template <int... Ds>
struct Instances {
  static bool has(int D) { return ((D == Ds) || ...); }
  template <typename... Args>
  static cudaError_t launch_for(int D, Args... args) {
    cudaError_t err = cudaSuccess;
    const bool hit = ((D == Ds && ((err = launch<Ds>(args...)), true)) || ...);
    return hit ? err : launch<0>(args...);
  }
};
using RegisterTaps = Instances<19, 15, 5>;

}  // namespace

extern "C" {

const char* expected_oks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// 1 when D has an instance with the taps in registers, 0 when D runs the
// runtime-D instance.
int expected_oks_register_taps(int D) {
  return RegisterTaps::has(D);
}

// heatmaps (BK = B*K maps of H x W, f32), fk (K x D, f32, D odd <= 64).
// locs (BK x 2) and vals (BK) may be null for the conv-only entry; conv_out
// (BK x H x W) may be null for the decode-only entry. Returns 0 or a CUDA
// error code.
int expected_oks_run(const void* heatmaps, const void* fk, void* locs, void* vals,
                     void* conv_out, int BK, int K, int H, int W, int D, float sx, float sy,
                     void* stream) {
  if (D > MAX_TAPS || D % 2 == 0) return (int)cudaErrorInvalidValue;
  const float* h = static_cast<const float*>(heatmaps);
  const float* f = static_cast<const float*>(fk);
  float* l = static_cast<float*>(locs);
  float* v = static_cast<float*>(vals);
  float* c = static_cast<float*>(conv_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)RegisterTaps::launch_for(D, h, f, l, v, c, BK, K, H, W, D, sx, sy, s);
}

}  // extern "C"
