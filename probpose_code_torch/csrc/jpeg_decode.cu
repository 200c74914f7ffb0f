// JPEG decode on the card.
//
// No TPU kernel is replaced: the JAX package decodes on the host with
// libjpeg-turbo through OpenCV (cv2.imread / cv2.imdecode in
// probpose_code_tpu/datasets/transforms/loading.py, and the opt-in native
// path csrc/image_pipeline.cpp). The card's machine has no OpenCV, so the
// port decodes the loader's JPEG bytes here, in the main process, into
// slots of one zeroed (B, Hmax, Wmax, 3) uint8 BGR buffer that the crop
// gather then reads (probpose_code_torch/ops/kernels/jpeg.py). The plain
// twin is the NumPy decoder probpose_code_torch/datasets/jpeg.py.
//
// The Huffman data is decoded on host threads, one image each
// (jpeg_exact.cuh), into each component's DCT coefficients; on the card,
// idct_kernel dequantizes and runs libjpeg-turbo's integer IDCT (one thread
// an 8x8 block) and pixel_kernel upsamples the chroma as its fancy
// upsampling does, converts with its integer YCbCr tables and writes the
// slot in EXIF orientation (one thread an output pixel): bit for bit
// cv2.imread's pixels. What bounds it: the host's Huffman decode (a serial
// bit stream an image); the kernels move about 5 bytes a pixel.
//
// nvJPEG is not used here: its IDCT and chroma interpolation are not
// libjpeg-turbo's (up to 5 grey levels off cv2.imread, which moved the
// golden val set's keypoints far from the JAX package's). Its batched
// decode is only the yardstick that chip_smoke.py times, in
// nvjpeg_batched.cu.
//
// Every entry returns 0, 1 (a stream the host decoder refuses), or
// 1000 + a CUDA error.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include "jpeg_exact.cuh"

namespace {

inline int cuda_code(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + (int)e; }

__global__ void idct_kernel(const int16_t* __restrict__ coef, const int32_t* __restrict__ quant,
                            const int64_t* __restrict__ pd, int nplanes, int64_t blocks, uint8_t* __restrict__ planes) {
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= blocks) return;
  int lo = 0, hi = nplanes - 1;  // the plane: the last whose first block is at or before g
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pd[mid * jx::P_FIELDS + jx::P_BLOCK] <= g) lo = mid;
    else hi = mid - 1;
  }
  const int64_t* p = pd + lo * jx::P_FIELDS;
  const int64_t local = g - p[jx::P_BLOCK], bw = p[jx::P_BW];
  const int64_t r = local / bw, c = local % bw;
  jx::idct_block(coef + p[jx::P_COEF] + 64 * local, quant + 64 * lo, planes + p[jx::P_PIX] + r * 64 * bw + c * 8, bw * 8);
}

__global__ void pixel_kernel(const uint8_t* __restrict__ planes, const int64_t* __restrict__ pd,
                             const int64_t* __restrict__ im, uint8_t* __restrict__ out, int Hmax, int Wmax) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (x >= Wmax || y >= Hmax) return;
  uint8_t bgr[3];
  if (!jx::pixel(planes, pd, im + (int64_t)i * jx::I_FIELDS, y, x, bgr)) return;
  uint8_t* o = out + (((int64_t)i * Hmax + y) * Wmax + x) * 3;
  o[0] = bgr[0];
  o[1] = bgr[1];
  o[2] = bgr[2];
}

// the host half's results for one batch
struct Batch {
  std::vector<jx::Image> images;
  int64_t coefs = 0, pix = 0, planes = 0, blocks = 0;
};

}  // namespace

extern "C" {

// Host half: the n streams' Huffman data decoded on up to
// `threads` host threads. On success *out holds the batch and totals its
// sizes (coefficients, plane bytes, planes, 8x8 blocks); on failure *bad is
// the stream and msg says why, and 1 is returned.
int jpeg_exact_decode_host(int n, const unsigned char* const* data, const size_t* lens, int threads, void** out,
                           int64_t* totals, int* bad, char* msg, int msg_len) {
  *out = nullptr;
  Batch* b = new Batch();
  b->images.resize(n);
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next++; i < n; i = next++) jx::entropy_decode(data[i], lens[i], b->images[i]);
  };
  std::vector<std::thread> pool;
  const int t = std::max(1, std::min(threads, n));
  for (int k = 1; k < t; ++k) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i) {
    const jx::Image& im = b->images[i];
    if (!im.error.empty()) {
      *bad = i;
      std::snprintf(msg, msg_len, "%s", im.error.c_str());
      delete b;
      return 1;
    }
    for (int c = 0; c < im.ncomp; ++c) {
      const jx::Comp& k = im.comp[c];
      b->coefs += (int64_t)k.coef.size();
      b->pix += (int64_t)k.bw * 8 * k.bh * 8;
      b->blocks += (int64_t)k.bw * k.bh;
      b->planes += 1;
    }
  }
  totals[0] = b->coefs;
  totals[1] = b->pix;
  totals[2] = b->planes;
  totals[3] = b->blocks;
  *out = b;
  return 0;
}

// The batch's coefficients, quantization tables (natural order, one row a
// plane) and descriptors into the caller's host buffers, sized by the
// totals; frees the batch.
int jpeg_exact_fill(void* batch, int16_t* coef, int32_t* quant, int64_t* pd, int64_t* im_desc) {
  Batch* b = static_cast<Batch*>(batch);
  int64_t coef_at = 0, pix_at = 0, block_at = 0, plane = 0;
  for (size_t i = 0; i < b->images.size(); ++i) {
    const jx::Image& im = b->images[i];
    int64_t* d = im_desc + (int64_t)i * jx::I_FIELDS;
    d[jx::I_PLANE0] = plane;
    d[jx::I_PLANE1] = im.ncomp == 3 ? plane + 1 : -1;
    d[jx::I_PLANE2] = im.ncomp == 3 ? plane + 2 : -1;
    d[jx::I_NCOMP] = im.ncomp;
    d[jx::I_W] = im.W;
    d[jx::I_H] = im.H;
    d[jx::I_HF] = im.ncomp == 3 ? im.hmax / im.comp[1].h : 1;
    d[jx::I_VF] = im.ncomp == 3 ? im.vmax / im.comp[1].v : 1;
    d[jx::I_ORIENT] = im.orientation;
    d[jx::I_RGB] = im.rgb;
    for (int c = 0; c < im.ncomp; ++c, ++plane) {
      const jx::Comp& k = im.comp[c];
      int64_t* p = pd + plane * jx::P_FIELDS;
      p[jx::P_COEF] = coef_at;
      p[jx::P_BLOCK] = block_at;
      p[jx::P_BW] = k.bw;
      p[jx::P_BH] = k.bh;
      p[jx::P_PIX] = pix_at;
      p[jx::P_WIDTH] = k.width;
      p[jx::P_HEIGHT] = k.height;
      std::copy(k.coef.begin(), k.coef.end(), coef + coef_at);
      std::copy(k.quant, k.quant + 64, quant + 64 * plane);
      coef_at += (int64_t)k.coef.size();
      pix_at += (int64_t)k.bw * 8 * k.bh * 8;
      block_at += (int64_t)k.bw * k.bh;
    }
  }
  delete b;
  return 0;
}

// Device half, on `stream`: the IDCT of every block into
// the planes (pix bytes), then every image into its slot of out (n x Hmax x
// Wmax x 3, zeroed by the caller).
int jpeg_exact_render(const void* coef, const void* quant, const void* pd, int nplanes, int64_t blocks, void* planes,
                      const void* im_desc, int n, void* out, int Hmax, int Wmax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    idct_kernel<<<(unsigned)((blocks + 127) / 128), 128, 0, s>>>(
        static_cast<const int16_t*>(coef), static_cast<const int32_t*>(quant), static_cast<const int64_t*>(pd), nplanes,
        blocks, static_cast<uint8_t*>(planes));
    const int e = cuda_code(cudaGetLastError());
    if (e) return e;
  }
  dim3 block(32, 8);
  dim3 grid((Wmax + 31) / 32, (Hmax + 7) / 8, n);
  pixel_kernel<<<grid, block, 0, s>>>(static_cast<const uint8_t*>(planes), static_cast<const int64_t*>(pd),
                                      static_cast<const int64_t*>(im_desc), static_cast<uint8_t*>(out), Hmax, Wmax);
  return cuda_code(cudaGetLastError());
}

const char* jpeg_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
