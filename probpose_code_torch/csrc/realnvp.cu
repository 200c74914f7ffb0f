// RLE's RealNVP flow, its log-density and its gradients, as hand-written
// CUDA for Hopper (sm_90a), f32, FMA units (no tensor cores).
//
// The flow (probpose_code_torch/models/utils/realnvp.py, whose
// RealNVP.log_prob_plain is this kernel's plain twin; the JAX package's
// probpose_code_tpu/models/utils/realnvp.py:37-53): six coupling layers i =
// 5, ..., 0, mask m = [0, 1] for even i and [1, 0] for odd i, so that
// component p (m_p = 1) is kept and q = i & 1 is transformed:
//   s = tanh(S_i(m z)), t = T_i(m z)  (S_i, T_i: Linear(2, 64), leaky ReLU,
//                                      Linear(64, 64), leaky ReLU, Linear(64, 2))
//   z_q = (z_q - t_q) exp(-s_q),      log_det -= s_q
//   log_prob = -|z|^2 / 2 - log(2 pi) + log_det.
// RLELoss evaluates it on every training step at N = B K rows (1,088 at B =
// 64 on COCO). It replaces no TPU kernel: the JAX package leaves it to XLA.
// In PyTorch it is some 150 small launches forward and more backward; here
// it is one launch forward and two backward.
//
// What bounds it: about 8,700 multiply-adds a net a row (the 64 x 64 layer
// dominates), 12 nets, 113.6 MFLOP at N = 1,088 forward: 0.0017 ms at 67
// TFLOP/s f32, far below a launch. The design keeps every row's 64-wide
// activations in registers and every layer's weights in shared memory.
//
// Parameters: one flat f32 buffer of 53,784 floats, layer by layer (8,964),
// the scale net then the translation net (4,482 each), each Linear's weight
// (out, in) then its bias: W1 (64, 2), b1, W2 (64, 64), b2, W3 (2, 64), b3.
// The gradient has the same layout.
//
// realnvp_forward_kernel: eight lanes of a warp a row (four for the scale
// net, four for the translation net; each lane computes the 64 first-layer
// activations and 16 of the 64 second-layer ones, then the four lanes sum
// their parts of the last layer by shuffles, and the two nets swap s and t);
// 32 rows a block. Each layer's weights are staged in shared memory (38 KB,
// the 64 x 64 matrix's rows padded to 68 so that the eight lanes of a row
// read eight float4 in eight distinct groups of banks); the four rows of a
// warp read the same words (broadcast). It writes log_prob and, for the
// backward, z at each layer's input (N x 6 x 2).
// realnvp_backward_kernel: the same lanes, layers i = 0, ..., 5: the layer's
// nets recomputed from the saved z, then the chain rule back to z and to
// the nets' inputs. Each row's activations go to shared memory as soon as
// they are made (their registers free before the gradients'), and so do
// their gradients; the block sums the weight gradients over its 32 rows
// (each thread some weights, the rows in order) into its own slice of a
// partial-sums buffer. realnvp_reduce_kernel sums the slices in block order:
// no atomics, so two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int LAYERS = 6;
constexpr int NET = 2 * H + H + H * H + H + 2 * H + 2;  // 4,482
constexpr int LAYER = 2 * NET;                          // 8,964
constexpr int TOTAL = LAYERS * LAYER;                   // 53,784
// the packed layout of a net
constexpr int P_W1 = 0, P_B1 = 128, P_W2 = 192, P_B2 = 4288, P_W3 = 4352, P_B3 = 4480;
// its layout in shared memory: W2's rows padded to 68 floats, the
// translation net at an offset of 16 banks from the scale net
constexpr int W2_STRIDE = 68;
constexpr int S_W2 = 0, S_W1 = 4352, S_B1 = 4480, S_B2 = 4544, S_W3 = 4608, S_B3 = 4736;
constexpr int SNET = 4752;
constexpr int SMEM_WEIGHTS = 2 * SNET;  // 9,504 floats

constexpr int ROWS = 32;  // rows a block
constexpr int LANES = 8;  // threads a row
constexpr int THREADS = ROWS * LANES;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SLOPE = 0.01f;
constexpr float LOG_2PI = 1.8378770664093453f;

// the tile's buffers in the backward's shared memory, after the weights:
// per net and row the 64 first-layer activations, the 64 second-layer ones
// and the gradients of both layers' pre-activations; the last layer's (2)
// per net and row; the nets' input m z (2) per row
constexpr int T_H1 = SMEM_WEIGHTS;
constexpr int T_H2 = T_H1 + 2 * ROWS * H;
constexpr int T_DA1 = T_H2 + 2 * ROWS * H;
constexpr int T_DA2 = T_DA1 + 2 * ROWS * H;
constexpr int T_DA3 = T_DA2 + 2 * ROWS * H;
constexpr int T_ZM = T_DA3 + 2 * ROWS * 2;
constexpr int SMEM_BACKWARD = T_ZM + ROWS * 2;  // 26,080 floats

__device__ __forceinline__ float lrelu(float a) { return a > 0.f ? a : SLOPE * a; }

__device__ __forceinline__ int smem_index(int f) {
  if (f < P_B1) return S_W1 + (f - P_W1);
  if (f < P_W2) return S_B1 + (f - P_B1);
  if (f < P_B2) return ((f - P_W2) >> 6) * W2_STRIDE + ((f - P_W2) & 63);
  if (f < P_W3) return S_B2 + (f - P_B2);
  if (f < P_B3) return S_W3 + (f - P_W3);
  return S_B3 + (f - P_B3);
}

// layer i's weights from the packed buffer into shared memory
__device__ __forceinline__ void stage(float* w, const float* __restrict__ layer) {
  for (int e = threadIdx.x; e < LAYER; e += THREADS) {
    const int net = e >= NET ? 1 : 0;
    w[net * SNET + smem_index(e - net * NET)] = __ldg(layer + e);
  }
}

// one lane's part of a net on the input (zm0, zm1): the 64 first-layer
// activations h1 and the bits of their pre-activations' signs; the 16
// second-layer activations j = 4 jj + part and their signs' bits; the
// last layer's two outputs summed over the net's four lanes
struct Net {
  float h1[H];
  unsigned long long pos1;
  float h2[16];
  unsigned pos2;
  float a3[2];
};

__device__ __forceinline__ void net_forward(const float* W, float zm0, float zm1, int part, Net& o) {
  o.pos1 = 0ull;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float a = fmaf(W[S_W1 + 2 * k], zm0, fmaf(W[S_W1 + 2 * k + 1], zm1, W[S_B1 + k]));
    o.h1[k] = lrelu(a);
    o.pos1 |= (a > 0.f ? 1ull : 0ull) << k;
  }
  float a3_0 = 0.f, a3_1 = 0.f;
  o.pos2 = 0u;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int j = 4 * jj + part;
    const float4* row = reinterpret_cast<const float4*>(W + S_W2 + j * W2_STRIDE);
    float acc = W[S_B2 + j];
#pragma unroll
    for (int k4 = 0; k4 < H / 4; ++k4) {
      const float4 v = row[k4];
      acc = fmaf(v.x, o.h1[4 * k4], acc);
      acc = fmaf(v.y, o.h1[4 * k4 + 1], acc);
      acc = fmaf(v.z, o.h1[4 * k4 + 2], acc);
      acc = fmaf(v.w, o.h1[4 * k4 + 3], acc);
    }
    o.h2[jj] = lrelu(acc);
    o.pos2 |= (acc > 0.f ? 1u : 0u) << jj;
    a3_0 = fmaf(W[S_W3 + j], o.h2[jj], a3_0);
    a3_1 = fmaf(W[S_W3 + H + j], o.h2[jj], a3_1);
  }
  a3_0 += __shfl_xor_sync(FULL, a3_0, 1);
  a3_0 += __shfl_xor_sync(FULL, a3_0, 2);
  a3_1 += __shfl_xor_sync(FULL, a3_1, 1);
  a3_1 += __shfl_xor_sync(FULL, a3_1, 2);
  o.a3[0] = a3_0 + W[S_B3];
  o.a3[1] = a3_1 + W[S_B3 + 1];
}

// (s_q, t_q) in every lane of the row: the scale net's lanes take tanh of
// their output, the translation net's keep theirs, and the halves swap
__device__ __forceinline__ void scale_and_shift(const Net& o, int net, int q, float& s, float& t) {
  const float a = q ? o.a3[1] : o.a3[0];
  const float mine = net == 0 ? tanhf(a) : a;
  const float other = __shfl_xor_sync(FULL, mine, 4);
  s = net == 0 ? mine : other;
  t = net == 0 ? other : mine;
}

__global__ void __launch_bounds__(THREADS)
    realnvp_forward_kernel(const float* __restrict__ x, const float* __restrict__ params, float* __restrict__ logp,
                           float* __restrict__ zs, int n) {
  __shared__ __align__(16) float w[SMEM_WEIGHTS];
  const int lane = threadIdx.x & (LANES - 1);
  const int net = lane >> 2, part = lane & 3;
  const int row = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = row < n;
  float z0 = valid ? __ldg(x + 2 * row) : 0.f, z1 = valid ? __ldg(x + 2 * row + 1) : 0.f;
  float log_det = 0.f;
  Net o;
  for (int i = LAYERS - 1; i >= 0; --i) {
    __syncthreads();
    stage(w, params + i * LAYER);
    __syncthreads();
    if (valid && lane == 0) {
      zs[(row * LAYERS + i) * 2] = z0;
      zs[(row * LAYERS + i) * 2 + 1] = z1;
    }
    const int q = i & 1;
    net_forward(w + net * SNET, q == 0 ? 0.f : z0, q == 1 ? 0.f : z1, part, o);
    float s, t;
    scale_and_shift(o, net, q, s, t);
    if (q == 0) {
      z0 = (z0 - t) * expf(-s);
    } else {
      z1 = (z1 - t) * expf(-s);
    }
    log_det -= s;
  }
  if (valid && lane == 0) logp[row] = -0.5f * (z0 * z0 + z1 * z1) - LOG_2PI + log_det;
}

__global__ void __launch_bounds__(THREADS)
    realnvp_backward_kernel(const float* __restrict__ grad, const float* __restrict__ zs,
                            const float* __restrict__ params, float* __restrict__ dx, float* __restrict__ partial,
                            int n) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  const int lane = threadIdx.x & (LANES - 1);
  const int net = lane >> 2, part = lane & 3;
  const int r = threadIdx.x / LANES;
  const int row = blockIdx.x * ROWS + r;
  const bool valid = row < n;
  const float g = valid ? __ldg(grad + row) : 0.f;
  float gz0 = 0.f, gz1 = 0.f;  // the gradient of the current layer's output
  Net o;
  for (int i = 0; i < LAYERS; ++i) {
    __syncthreads();
    stage(w, params + i * LAYER);
    __syncthreads();
    const int q = i & 1;
    const float z0 = valid ? __ldg(zs + (row * LAYERS + i) * 2) : 0.f;
    const float z1 = valid ? __ldg(zs + (row * LAYERS + i) * 2 + 1) : 0.f;
    const float zm0 = q == 0 ? 0.f : z0, zm1 = q == 1 ? 0.f : z1;
    const float* W = w + net * SNET;
    net_forward(W, zm0, zm1, part, o);
    // the activations to the tile's buffers at once, so that their registers free before the gradients'
    float* h1_tile = smem + T_H1 + (net * ROWS + r) * H;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      if ((k >> 4) == part) h1_tile[k] = o.h1[k];
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) smem[T_H2 + (net * ROWS + r) * H + 4 * jj + part] = o.h2[jj];
    float s, t;
    scale_and_shift(o, net, q, s, t);
    const float e = expf(-s);
    const float zq = q ? z1 : z0;
    if (i == 0) {  // the last layer of the flow: d log_prob / dz = -z
      const float out_q = (zq - t) * e;
      gz0 = -(q == 0 ? out_q : z0) * g;
      gz1 = -(q == 1 ? out_q : z1) * g;
    }
    const float gq = q ? gz1 : gz0;
    float dz0 = q == 0 ? gq * e : gz0;
    float dz1 = q == 1 ? gq * e : gz1;
    const float ds = -gq * (zq - t) * e - g;  // log_det -= s_q
    const float da3q = net == 0 ? ds * (1.f - s * s) : -gq * e;
    // the second layer's gradients (this lane's 16) and the first's (summed over the net's lanes)
    float da2[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = 4 * jj + part;
      da2[jj] = W[S_W3 + q * H + j] * da3q * (((o.pos2 >> jj) & 1u) ? 1.f : SLOPE);
    }
    float dh1[H];
#pragma unroll
    for (int k = 0; k < H; ++k) dh1[k] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float4* wrow = reinterpret_cast<const float4*>(W + S_W2 + (4 * jj + part) * W2_STRIDE);
#pragma unroll
      for (int k4 = 0; k4 < H / 4; ++k4) {
        const float4 v = wrow[k4];
        dh1[4 * k4] = fmaf(v.x, da2[jj], dh1[4 * k4]);
        dh1[4 * k4 + 1] = fmaf(v.y, da2[jj], dh1[4 * k4 + 1]);
        dh1[4 * k4 + 2] = fmaf(v.z, da2[jj], dh1[4 * k4 + 2]);
        dh1[4 * k4 + 3] = fmaf(v.w, da2[jj], dh1[4 * k4 + 3]);
      }
    }
    float dzm0 = 0.f, dzm1 = 0.f;
    float* da1_tile = smem + T_DA1 + (net * ROWS + r) * H;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      dh1[k] += __shfl_xor_sync(FULL, dh1[k], 1);
      dh1[k] += __shfl_xor_sync(FULL, dh1[k], 2);
      const float da1 = dh1[k] * (((o.pos1 >> k) & 1ull) ? 1.f : SLOPE);
      dzm0 = fmaf(W[S_W1 + 2 * k], da1, dzm0);
      dzm1 = fmaf(W[S_W1 + 2 * k + 1], da1, dzm1);
      if ((k >> 4) == part) da1_tile[k] = da1;
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) smem[T_DA2 + (net * ROWS + r) * H + 4 * jj + part] = da2[jj];
    if (part == 0) {
      smem[T_DA3 + (net * ROWS + r) * 2 + q] = da3q;
      smem[T_DA3 + (net * ROWS + r) * 2 + (1 - q)] = 0.f;
    }
    if (lane == 0) {
      smem[T_ZM + 2 * r] = zm0;
      smem[T_ZM + 2 * r + 1] = zm1;
    }
    // both nets read m z: the kept component takes their gradients' sum
    dzm0 += __shfl_xor_sync(FULL, dzm0, 4);
    dzm1 += __shfl_xor_sync(FULL, dzm1, 4);
    if (q == 0) {
      dz1 += dzm1;
    } else {
      dz0 += dzm0;
    }
    gz0 = dz0;
    gz1 = dz1;
    __syncthreads();
    // the block's sums over its rows of this layer's weight gradients, in row order
    float* out = partial + (long long)blockIdx.x * TOTAL + i * LAYER;
    for (int e2 = threadIdx.x; e2 < LAYER; e2 += THREADS) {
      const int nn = e2 >= NET ? 1 : 0;
      const int f = e2 - nn * NET;
      const float* H1 = smem + T_H1 + nn * ROWS * H;
      const float* H2 = smem + T_H2 + nn * ROWS * H;
      const float* DA1 = smem + T_DA1 + nn * ROWS * H;
      const float* DA2 = smem + T_DA2 + nn * ROWS * H;
      const float* DA3 = smem + T_DA3 + nn * ROWS * 2;
      const float* ZM = smem + T_ZM;
      float sum = 0.f;
      if (f < P_B1) {
        const int j = f >> 1, c = f & 1;
        for (int rr = 0; rr < ROWS; ++rr) sum = fmaf(DA1[rr * H + j], ZM[rr * 2 + c], sum);
      } else if (f < P_W2) {
        const int j = f - P_B1;
        for (int rr = 0; rr < ROWS; ++rr) sum += DA1[rr * H + j];
      } else if (f < P_B2) {
        const int j = (f - P_W2) >> 6, k = (f - P_W2) & 63;
        for (int rr = 0; rr < ROWS; ++rr) sum = fmaf(DA2[rr * H + j], H1[rr * H + k], sum);
      } else if (f < P_W3) {
        const int j = f - P_B2;
        for (int rr = 0; rr < ROWS; ++rr) sum += DA2[rr * H + j];
      } else if (f < P_B3) {
        const int c = (f - P_W3) >> 6, j = (f - P_W3) & 63;
        for (int rr = 0; rr < ROWS; ++rr) sum = fmaf(DA3[rr * 2 + c], H2[rr * H + j], sum);
      } else {
        const int c = f - P_B3;
        for (int rr = 0; rr < ROWS; ++rr) sum += DA3[rr * 2 + c];
      }
      out[e2] = sum;
    }
  }
  if (valid && lane == 0) {
    dx[2 * row] = gz0;
    dx[2 * row + 1] = gz1;
  }
}

__global__ void realnvp_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= TOTAL) return;
  float sum = 0.f;
  for (int b = 0; b < tiles; ++b) sum += __ldg(partial + (long long)b * TOTAL + e);
  out[e] = sum;
}

}  // namespace

extern "C" {

const char* realnvp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int realnvp_tiles(int n) { return (n + ROWS - 1) / ROWS; }

int realnvp_parameter_count() { return TOTAL; }

// x: n x 2; params: TOTAL floats; logp: n; zs: n x 6 x 2 (z at each layer's input).
int realnvp_forward(const void* x, const void* params, void* logp, void* zs, int n, void* stream) {
  if (n <= 0) return 0;
  realnvp_forward_kernel<<<realnvp_tiles(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(logp),
      static_cast<float*>(zs), n);
  return (int)cudaGetLastError();
}

// grad: n (the gradient of logp); zs and params as the forward's; dx: n x 2;
// partial: realnvp_tiles(n) x TOTAL scratch; dparams: TOTAL floats.
int realnvp_backward(const void* grad, const void* zs, const void* params, void* dx, void* partial, void* dparams,
                     int n, void* stream) {
  if (n <= 0) return 0;
  const int bytes = SMEM_BACKWARD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(realnvp_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = realnvp_tiles(n);
  realnvp_backward_kernel<<<tiles, THREADS, bytes, s>>>(
      static_cast<const float*>(grad), static_cast<const float*>(zs), static_cast<const float*>(params),
      static_cast<float*>(dx), static_cast<float*>(partial), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  realnvp_reduce_kernel<<<(TOTAL + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                            static_cast<float*>(dparams), tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
