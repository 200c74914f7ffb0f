// nvJPEG's batched decode: the yardstick of the port's JPEG decode.
//
// The port never calls this source. chip_smoke.py times it beside the
// port's decode (jpeg_decode.cu) as the library call for nearly the same
// function (`library_ms`), and reports how far its pixels are from the
// plain decoder's. It decodes on nvJPEG's GPU-hybrid backend, which decodes
// the Huffman data of baseline streams on the card when the batch holds
// more than 50, with the chroma upsampled by interpolation (nvJPEG's default
// repeats samples, which put up to 105 grey levels between it and
// libjpeg-turbo's fancy upsampling on the golden JPEGs; with interpolation
// 4). Images come out as stored: EXIF orientation is not applied. The
// hardware backend (the JPEG engines) refuses the H100 80GB HBM3 with
// NVJPEG_STATUS_ARCH_MISMATCH.
//
// Every entry returns 0, an nvJPEG status (1-99), or 1000 + a CUDA error.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <vector>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = 0;  // the batch size nvjpegDecodeBatchedInitialize was last given
};

inline int cuda_code(cudaError_t e) { return e == cudaSuccess ? 0 : 1000 + (int)e; }

}  // namespace

extern "C" {

const char* nvjpeg_batched_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// A handle and decode state on the GPU-hybrid backend; *out is null on failure.
int nvjpeg_batched_create(void** out) {
  *out = nullptr;
  Context* c = new Context();
  int st = (int)nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr, nullptr,
                               NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION, &c->handle);
  if (st == 0) st = (int)nvjpegJpegStateCreate(c->handle, &c->state);
  if (st != 0) {
    if (c->state) nvjpegJpegStateDestroy(c->state);
    if (c->handle) nvjpegDestroy(c->handle);
    delete c;
    return st;
  }
  *out = c;
  return 0;
}

int nvjpeg_batched_destroy(void* ctx) {
  Context* c = static_cast<Context*>(ctx);
  int st = (int)nvjpegJpegStateDestroy(c->state);
  const int st2 = (int)nvjpegDestroy(c->handle);
  delete c;
  return st ? st : st2;
}

// n images in one call on `stream`, BGR interleaved, image i into dsts[i]
// with pitches[i] bytes a row.
int nvjpeg_batched_decode(void* ctx, int n, const unsigned char* const* data, const size_t* lens,
                          unsigned char* const* dsts, const int* pitches, void* stream) {
  Context* c = static_cast<Context*>(ctx);
  int st = 0;
  if (c->batch != n) {
    st = (int)nvjpegDecodeBatchedInitialize(c->handle, c->state, n, 1, NVJPEG_OUTPUT_BGRI);
    if (st != 0) return st;
    c->batch = n;
  }
  std::vector<nvjpegImage_t> imgs(n);
  for (int i = 0; i < n; ++i) {
    imgs[i] = nvjpegImage_t{};
    imgs[i].channel[0] = dsts[i];
    imgs[i].pitch[0] = (size_t)pitches[i];
  }
  st = (int)nvjpegDecodeBatched(c->handle, c->state, data, lens, imgs.data(), static_cast<cudaStream_t>(stream));
  if (st != 0) return st;
  return cuda_code(cudaGetLastError());
}

}  // extern "C"
