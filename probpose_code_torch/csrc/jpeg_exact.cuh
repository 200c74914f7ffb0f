// The exact JPEG decode: libjpeg-turbo's arithmetic, bit for bit.
//
// Host part (C++): the marker parser and the Huffman decoder (sequential and
// progressive, restart intervals) that turn a stream into each component's
// quantized DCT coefficients; a port of probpose_code_torch/datasets/jpeg.py,
// run on host threads, one image each.
// Device part: per-block and per-pixel functions, __host__ __device__, that
// the kernels of jpeg_decode.cu run on the card: dequantization and
// jidctint.c's integer "islow" IDCT with its range limit; jdsample.c's fancy
// upsampling (h2v1, h2v2 triangles where the chroma is more than 2 samples
// wide, else a box copy; h1v2 always a triangle) with the last row and column
// repeated; jdcolor.c's integer YCbCr -> BGR; and the EXIF orientation as
// cv2.imread applies it. Compiled without nvcc (JPEG_HOST_ONLY), the same
// functions run on the host.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#ifdef __CUDACC__
#define JX_HD __host__ __device__
#else
#define JX_HD
#endif

namespace jx {

// fields of a plane descriptor (int64 each): one component of one image
enum PlaneField { P_COEF = 0, P_BLOCK, P_BW, P_BH, P_PIX, P_WIDTH, P_HEIGHT, P_FIELDS };
// fields of an image descriptor (int64 each)
enum ImageField { I_PLANE0 = 0, I_PLANE1, I_PLANE2, I_NCOMP, I_W, I_H, I_HF, I_VF, I_ORIENT, I_RGB, I_FIELDS };

// zigzag -> natural order, with libjpeg's 16 guard entries
JX_HD inline int natural(int k) {
  const int z[80] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
                     40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
                     29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                     47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};
  return z[k];
}

// jdmaster.c's post-IDCT range limit, indexed by x & 1023
JX_HD inline uint8_t range_limit(int64_t x) {
  const int i = (int)(x & 1023);
  return (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
}

// one 1-D pass of jpeg_idct_islow over in[0..7] (stride s), descaled by `shift`
JX_HD inline void idct_pass(const int64_t* d, int s, int shift, int64_t* o, int os) {
  int64_t z2 = d[2 * s], z3 = d[6 * s];
  int64_t z1 = (z2 + z3) * 4433;
  const int64_t tmp2 = z1 - z3 * 15137;
  const int64_t tmp3 = z1 + z2 * 6270;
  const int64_t tmp0 = (d[0] + d[4 * s]) * 8192;
  const int64_t tmp1 = (d[0] - d[4 * s]) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = d[7 * s], t1 = d[5 * s], t2 = d[3 * s], t3 = d[1 * s];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = (int64_t)1 << (shift - 1);
  o[0] = (tmp10 + t3 + half) >> shift;
  o[7 * os] = (tmp10 - t3 + half) >> shift;
  o[1 * os] = (tmp11 + t2 + half) >> shift;
  o[6 * os] = (tmp11 - t2 + half) >> shift;
  o[2 * os] = (tmp12 + t1 + half) >> shift;
  o[5 * os] = (tmp12 - t1 + half) >> shift;
  o[3 * os] = (tmp13 + t0 + half) >> shift;
  o[4 * os] = (tmp13 - t0 + half) >> shift;
}

// one 8x8 block: natural-order coefficients times the quantization table
// (natural order), IDCT, range limit, into out (pitch bytes a row)
JX_HD inline void idct_block(const int16_t* coef, const int32_t* quant, uint8_t* out, int64_t pitch) {
  int64_t in[64], ws[64], row[8];
  for (int i = 0; i < 64; ++i) in[i] = (int64_t)coef[i] * quant[i];
  for (int c = 0; c < 8; ++c) idct_pass(in + c, 8, 11, ws + c, 8);  // pass 1: down each column
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, 18, row, 1);  // pass 2: along each row
    for (int c = 0; c < 8; ++c) out[r * pitch + c] = range_limit(row[c]);
  }
}

JX_HD inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// one chroma sample at stored pixel (sy, sx), upsampled by (hf, vf)
JX_HD inline int chroma(const uint8_t* p, int64_t pitch, int cw, int ch, int hf, int vf, int sy, int sx) {
  if (hf == 1 && vf == 1) return p[sy * pitch + sx];
  if (hf == 2 && cw <= 2) return p[(sy / vf) * pitch + (sx >> 1)];  // h2v1_upsample / h2v2_upsample
  if (hf == 1) {  // h1v2
    const int j = sy >> 1;
    const int far = (sy & 1) ? clampi(j + 1, 0, ch - 1) : clampi(j - 1, 0, ch - 1);
    return (3 * p[j * pitch + sx] + p[far * pitch + sx] + ((sy & 1) ? 2 : 1)) >> 2;
  }
  const int i = sx >> 1;
  const int ni = (sx & 1) ? clampi(i + 1, 0, cw - 1) : clampi(i - 1, 0, cw - 1);
  if (vf == 1) {  // h2v1
    const uint8_t* r = p + sy * pitch;
    return (3 * r[i] + r[ni] + ((sx & 1) ? 2 : 1)) >> 2;
  }
  const int j = sy >> 1;  // h2v2: column sums, the nearer row weighted 3
  const int far = (sy & 1) ? clampi(j + 1, 0, ch - 1) : clampi(j - 1, 0, ch - 1);
  const int s0 = 3 * p[j * pitch + i] + p[far * pitch + i];
  const int s1 = 3 * p[j * pitch + ni] + p[far * pitch + ni];
  return (3 * s0 + s1 + ((sx & 1) ? 7 : 8)) >> 4;
}

JX_HD inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// the BGR pixel at oriented (y, x) of image `im` (an image descriptor) whose
// planes' descriptors are `pd`, into bgr; false outside the image
JX_HD inline bool pixel(const uint8_t* planes, const int64_t* pd, const int64_t* im, int y, int x, uint8_t* bgr) {
  const int W = (int)im[I_W], H = (int)im[I_H], o = (int)im[I_ORIENT];
  const bool transposed = o >= 5;
  const int out_w = transposed ? H : W, out_h = transposed ? W : H;
  if (x >= out_w || y >= out_h) return false;
  const bool lr = o == 2 || o == 3 || o == 6 || o == 7;
  const bool ud = o == 3 || o == 4 || o == 7 || o == 8;
  const int tx = lr ? out_w - 1 - x : x, ty = ud ? out_h - 1 - y : y;
  const int sx = transposed ? ty : tx, sy = transposed ? tx : ty;
  const int64_t* p0 = pd + im[I_PLANE0] * P_FIELDS;
  const int64_t pitch0 = p0[P_BW] * 8;
  const int Y = planes[p0[P_PIX] + sy * pitch0 + sx];
  if (im[I_NCOMP] == 1) {
    bgr[0] = bgr[1] = bgr[2] = (uint8_t)Y;
    return true;
  }
  const int hf = (int)im[I_HF], vf = (int)im[I_VF];
  int c[2];
  for (int k = 0; k < 2; ++k) {
    const int64_t* q = pd + im[I_PLANE1 + k] * P_FIELDS;
    c[k] = chroma(planes + q[P_PIX], q[P_BW] * 8, (int)q[P_WIDTH], (int)q[P_HEIGHT], hf, vf, sy, sx);
  }
  if (im[I_RGB]) {
    bgr[0] = (uint8_t)c[1];
    bgr[1] = (uint8_t)c[0];
    bgr[2] = (uint8_t)Y;
    return true;
  }
  // jdcolor.c: FIX(1.40200) = 91881, FIX(1.77200) = 116130, FIX(0.71414) = 46802, FIX(0.34414) = 22554
  const int cb = c[0] - 128, cr = c[1] - 128;
  const int r = Y + (int)((91881LL * cr + 32768) >> 16);
  const int g = Y + (int)((-22554LL * cb + 32768 - 46802LL * cr) >> 16);
  const int b = Y + (int)((116130LL * cb + 32768) >> 16);
  bgr[0] = clamp255(b);
  bgr[1] = clamp255(g);
  bgr[2] = clamp255(r);
  return true;
}

// -- host: markers and entropy decoding ----------------------------------------

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0, bw = 0, bh = 0, coded_bw = 0, coded_bh = 0;
  std::vector<int16_t> coef;
  int32_t quant[64];
  bool quant_set = false;
};

struct Image {
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0, orientation = 0;
  bool progressive = false, rgb = false;
  Comp comp[3];
  std::string error;
};

struct Error {
  std::string what;
};

struct Huff {
  std::vector<uint16_t> lut;  // next 16 bits -> length << 8 | symbol; 0: no such code
};

// the unstuffed data of one restart interval, with zero padding to read past
struct Bits {
  std::vector<uint8_t> buf;
  size_t nbits = 0;
  size_t p = 0;
  inline void need() const {  // the 3 bytes a read looks at lie in the padded buffer
    if ((p >> 3) + 3 > buf.size()) throw Error{"truncated or corrupt JPEG stream (entropy-coded data ends early)"};
  }
  inline uint32_t peek16() const {
    need();
    const uint8_t* b = buf.data() + (p >> 3);
    const uint32_t w = ((uint32_t)b[0] << 16) | ((uint32_t)b[1] << 8) | b[2];
    return (w >> (8 - (p & 7))) & 0xFFFF;
  }
  inline int get(int n) {  // n <= 16
    if (n == 0) return 0;
    need();
    const uint8_t* b = buf.data() + (p >> 3);
    const uint32_t w = ((uint32_t)b[0] << 16) | ((uint32_t)b[1] << 8) | b[2];
    const int v = (int)((w >> (24 - n - (p & 7))) & ((1u << n) - 1));
    p += n;
    return v;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline int decode_symbol(Bits& br, const Huff& t) {
  const uint16_t e = t.lut[br.peek16()];
  if (e < 256) throw Error{"corrupt JPEG stream (a Huffman code that is not in its table)"};
  br.p += e >> 8;
  return e & 255;
}

struct Block {
  int slot;
  int16_t* coef;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len, Image& im) : d_(data), n_(len), im_(im) {}

  void run() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG stream (no SOI marker)"};
    size_t pos = 2;
    bool jfif = false, have_frame = false;
    int adobe = -1;
    int restart = 0;
    while (true) {
      if (pos + 1 >= n_) throw Error{"truncated JPEG stream (no EOI marker)"};
      if (d_[pos] != 0xFF) throw Error{"corrupt JPEG stream (no marker)"};
      while (pos + 1 < n_ && d_[pos + 1] == 0xFF) ++pos;
      if (pos + 1 >= n_) throw Error{"truncated JPEG stream (no EOI marker)"};
      const int m = d_[pos + 1];
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        pos += 2;
        continue;
      }
      if (pos + 4 > n_) throw Error{"truncated JPEG stream (in a marker segment)"};
      const size_t seglen = ((size_t)d_[pos + 2] << 8) | d_[pos + 3];
      const size_t end = pos + 2 + seglen;
      if (seglen < 2 || end > n_) throw Error{"truncated JPEG stream (in a marker segment)"};
      const uint8_t* b = d_ + pos + 4;
      const size_t bl = seglen - 2;
      if (m == 0xE0 && bl >= 5 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
      else if (m == 0xEE && bl >= 12 && std::memcmp(b, "Adobe", 5) == 0) adobe = b[11];
      else if (m == 0xE1 && !im_.orientation) im_.orientation = exif_orientation(b, bl);
      else if (m == 0xDB) quant_tables(b, bl);
      else if (m == 0xC4) huffman_tables(b, bl);
      else if (m == 0xDD) {
        if (bl < 2) throw Error{"corrupt JPEG stream (short DRI segment)"};
        restart = (b[0] << 8) | b[1];
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (have_frame) throw Error{"corrupt JPEG stream (two frame headers)"};
        frame(m, b, bl);
        have_frame = true;
      } else if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8) ) {
        throw Error{"unsupported JPEG (arithmetic, lossless or hierarchical)"};
      } else if (m == 0xDA) {
        if (!have_frame) throw Error{"corrupt JPEG stream (a scan before the frame header)"};
        pos = scan(b, bl, end, restart);
        continue;
      }
      pos = end;
    }
    if (!have_frame) throw Error{"corrupt JPEG stream (no frame header)"};
    for (int c = 0; c < im_.ncomp; ++c)
      if (!im_.comp[c].quant_set) throw Error{"corrupt JPEG stream (a component no scan codes)"};
    if (im_.orientation < 1 || im_.orientation > 8) im_.orientation = 0;
    if (im_.ncomp == 3) {
      const bool ids_rgb = im_.comp[0].id == 82 && im_.comp[1].id == 71 && im_.comp[2].id == 66;
      im_.rgb = !jfif && (adobe >= 0 ? adobe == 0 : ids_rgb);
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  Image& im_;
  int32_t qt_[4][64];
  bool qt_set_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];

  static int exif_orientation(const uint8_t* s, size_t len) {
    if (len < 14 || std::memcmp(s, "Exif\0\0", 6) != 0) return 0;
    const uint8_t* t = s + 6;
    const size_t tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 0;
    auto rd = [&](size_t off, int n) -> uint32_t {
      if (off + n > tl) return 0;
      uint32_t v = 0;
      for (int i = 0; i < n; ++i) v |= (uint32_t)t[off + (le ? i : n - 1 - i)] << (8 * i);
      return v;
    };
    if (rd(2, 2) != 42) return 0;
    const uint32_t ifd = rd(4, 4);
    if ((size_t)ifd + 2 > tl) return 0;
    const uint32_t cnt = rd(ifd, 2);
    for (uint32_t i = 0; i < cnt; ++i) {
      const size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > tl) return 0;
      if (rd(e, 2) == 0x0112) return (int)rd(e + 8, 2);
    }
    return 0;
  }

  void quant_tables(const uint8_t* b, size_t bl) {
    size_t pos = 0;
    while (pos < bl) {
      const int pq = b[pos] >> 4, tq = b[pos] & 15;
      const size_t n = pq ? 128 : 64;
      if (pos + 1 + n > bl || tq > 3) throw Error{"corrupt JPEG stream (bad quantization table)"};
      for (int k = 0; k < 64; ++k)
        qt_[tq][natural(k)] = pq ? (b[pos + 1 + 2 * k] << 8) | b[pos + 2 + 2 * k] : b[pos + 1 + k];
      qt_set_[tq] = true;
      pos += 1 + n;
    }
  }

  void huffman_tables(const uint8_t* b, size_t bl) {
    size_t pos = 0;
    while (pos < bl) {
      if (pos + 17 > bl) throw Error{"corrupt JPEG stream (short Huffman table)"};
      const int tc = b[pos] >> 4, th = b[pos] & 15;
      const uint8_t* counts = b + pos + 1;
      size_t total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (tc > 1 || th > 3 || pos + 17 + total > bl) throw Error{"corrupt JPEG stream (bad Huffman table)"};
      const uint8_t* sym = b + pos + 17;
      Huff& t = tc ? ac_[th] : dc_[th];
      t.lut.assign(1 << 16, 0);
      uint32_t code = 0;
      size_t k = 0;
      for (int len = 1; len <= 16; ++len) {
        for (int i = 0; i < counts[len - 1]; ++i) {
          if (code >= (1u << len)) throw Error{"corrupt JPEG stream (bad Huffman table)"};
          const uint16_t e = (uint16_t)((len << 8) | sym[k++]);
          for (uint32_t x = code << (16 - len); x < ((code + 1) << (16 - len)); ++x) t.lut[x] = e;
          ++code;
        }
        code <<= 1;
      }
      pos += 17 + total;
    }
  }

  void frame(int m, const uint8_t* b, size_t bl) {
    if (bl < 6) throw Error{"corrupt JPEG stream (short frame header)"};
    if (b[0] != 8) throw Error{"unsupported JPEG (not 8-bit samples)"};
    im_.H = (b[1] << 8) | b[2];
    im_.W = (b[3] << 8) | b[4];
    im_.ncomp = b[5];
    if (im_.ncomp != 1 && im_.ncomp != 3) throw Error{"unsupported JPEG (not 1 or 3 components)"};
    if (bl < 6 + 3 * (size_t)im_.ncomp || im_.W == 0 || im_.H == 0)
      throw Error{"corrupt JPEG stream (bad frame header)"};
    im_.progressive = m == 0xC2;
    for (int i = 0; i < im_.ncomp; ++i) {
      Comp& c = im_.comp[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Error{"corrupt JPEG stream (a sampling factor out of 1-4)"};
      im_.hmax = c.h > im_.hmax ? c.h : im_.hmax;
      im_.vmax = c.v > im_.vmax ? c.v : im_.vmax;
    }
    if (im_.ncomp == 3) {
      const Comp* c = im_.comp;
      const bool chroma_one = c[1].h == 1 && c[1].v == 1 && c[2].h == 1 && c[2].v == 1;
      if (!chroma_one || c[0].h > 2 || c[0].v > 2) throw Error{"unsupported JPEG (chroma sampling)"};
    }
    im_.mcux = (im_.W + 8 * im_.hmax - 1) / (8 * im_.hmax);
    im_.mcuy = (im_.H + 8 * im_.vmax - 1) / (8 * im_.vmax);
    for (int i = 0; i < im_.ncomp; ++i) {
      Comp& c = im_.comp[i];
      c.width = (im_.W * c.h + im_.hmax - 1) / im_.hmax;
      c.height = (im_.H * c.v + im_.vmax - 1) / im_.vmax;
      c.bw = im_.mcux * c.h;
      c.bh = im_.mcuy * c.v;
      c.coded_bw = (c.width + 7) / 8;
      c.coded_bh = (c.height + 7) / 8;
      c.coef.assign((size_t)64 * c.bw * c.bh, 0);
    }
  }

  // the entropy-coded data from pos, split at RST markers and unstuffed;
  // returns the offset of the marker that ends it
  size_t entropy_data(size_t pos, std::vector<Bits>& chunks) {
    size_t i = pos;
    chunks.emplace_back();
    while (true) {
      if (i + 1 >= n_) throw Error{"truncated JPEG stream (the scan runs to the end of the data)"};
      const uint8_t b = d_[i];
      if (b != 0xFF) {
        chunks.back().buf.push_back(b);
        ++i;
        continue;
      }
      const uint8_t nxt = d_[i + 1];
      if (nxt == 0) {
        chunks.back().buf.push_back(0xFF);
        i += 2;
      } else if (nxt == 0xFF) {
        ++i;  // a fill byte
      } else if (nxt >= 0xD0 && nxt <= 0xD7) {
        chunks.emplace_back();
        i += 2;
      } else {
        for (auto& c : chunks) {
          c.nbits = 8 * c.buf.size();
          c.buf.resize(c.buf.size() + 8, 0);
        }
        return i;
      }
    }
  }

  size_t scan(const uint8_t* b, size_t bl, size_t end, int restart) {
    const int ns = bl ? b[0] : 0;
    if (ns < 1 || ns > 3 || bl < (size_t)(1 + 2 * ns + 3)) throw Error{"corrupt JPEG stream (bad scan header)"};
    Comp* members[3];
    int tdc[3], tac[3];
    for (int i = 0; i < ns; ++i) {
      members[i] = nullptr;
      for (int c = 0; c < im_.ncomp; ++c)
        if (im_.comp[c].id == b[1 + 2 * i]) members[i] = &im_.comp[c];
      if (!members[i]) throw Error{"corrupt JPEG stream (a scan names an unknown component)"};
      tdc[i] = b[2 + 2 * i] >> 4 & 3;
      tac[i] = b[2 + 2 * i] & 3;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    for (int i = 0; i < ns; ++i) {
      Comp& c = *members[i];
      if (!c.quant_set) {
        if (!qt_set_[c.tq]) throw Error{"corrupt JPEG stream (a missing quantization table)"};
        std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
        c.quant_set = true;
      }
    }
    if (!im_.progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss > 0 && ns != 1) || (ss == 0 && se != 0) || al > 13) {
      throw Error{"corrupt JPEG stream (bad progressive scan parameters)"};
    }
    std::vector<Bits> chunks;
    const size_t next = entropy_data(end, chunks);

    // the scan's MCUs: their blocks
    std::vector<std::vector<Block>> mcus;
    if (ns == 1) {
      Comp& c = *members[0];
      mcus.reserve((size_t)c.coded_bw * c.coded_bh);
      for (int r = 0; r < c.coded_bh; ++r)
        for (int q = 0; q < c.coded_bw; ++q) mcus.push_back({Block{0, c.coef.data() + 64 * ((size_t)r * c.bw + q)}});
    } else {
      mcus.reserve((size_t)im_.mcux * im_.mcuy);
      for (int my = 0; my < im_.mcuy; ++my)
        for (int mx = 0; mx < im_.mcux; ++mx) {
          std::vector<Block> blocks;
          for (int s = 0; s < ns; ++s) {
            Comp& c = *members[s];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                blocks.push_back(Block{s, c.coef.data() + 64 * ((size_t)(my * c.v + v) * c.bw + mx * c.h + h)});
          }
          mcus.push_back(std::move(blocks));
        }
    }
    const size_t per = restart ? (size_t)restart : mcus.size();
    const size_t intervals = (mcus.size() + per - 1) / per;
    if (chunks.size() < intervals) throw Error{"truncated JPEG stream (restart intervals missing)"};
    const Huff* dcl[3];
    const Huff* acl[3];
    for (int s = 0; s < ns; ++s) {
      dcl[s] = &dc_[tdc[s]];
      acl[s] = &ac_[tac[s]];
      if ((ss == 0 && ah == 0 && dcl[s]->lut.empty()) || (se > 0 && acl[s]->lut.empty()))
        throw Error{"corrupt JPEG stream (a missing Huffman table)"};
    }
    for (size_t i = 0; i < intervals; ++i) {
      Bits& br = chunks[i];
      const size_t lo = i * per, hi = lo + per < mcus.size() ? lo + per : mcus.size();
      if (!im_.progressive) sequential(br, mcus, lo, hi, dcl, acl, ns);
      else if (ss == 0) dc_scan(br, mcus, lo, hi, dcl, ns, ah, al);
      else if (ah == 0) ac_first(br, mcus, lo, hi, *acl[0], ss, se, al);
      else ac_refine(br, mcus, lo, hi, *acl[0], ss, se, al);
      if (br.p > br.nbits) throw Error{"truncated or corrupt JPEG stream (entropy-coded data ends early)"};
    }
    return next;
  }

  static void sequential(Bits& br, std::vector<std::vector<Block>>& mcus, size_t lo, size_t hi, const Huff** dcl,
                         const Huff** acl, int ns) {
    int pred[3] = {0, 0, 0};
    for (size_t m = lo; m < hi; ++m) {
      for (const Block& bk : mcus[m]) {
        const int s = decode_symbol(br, *dcl[bk.slot]);
        if (s > 16) throw Error{"corrupt JPEG stream (a DC category above 16)"};
        if (s) pred[bk.slot] += extend(br.get(s), s);
        bk.coef[0] = (int16_t)pred[bk.slot];
        const Huff& t = *acl[bk.slot];
        for (int k = 1; k < 64;) {
          const int rs = decode_symbol(br, t);
          const int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            bk.coef[natural(k)] = (int16_t)extend(br.get(sz), sz);
            ++k;
          } else if (rs == 0xF0) {
            k += 16;
          } else {
            break;
          }
        }
      }
    }
    (void)ns;
  }

  static void dc_scan(Bits& br, std::vector<std::vector<Block>>& mcus, size_t lo, size_t hi, const Huff** dcl, int ns,
                      int ah, int al) {
    int pred[3] = {0, 0, 0};
    for (size_t m = lo; m < hi; ++m) {
      for (const Block& bk : mcus[m]) {
        if (ah == 0) {
          const int s = decode_symbol(br, *dcl[bk.slot]);
          if (s > 16) throw Error{"corrupt JPEG stream (a DC category above 16)"};
          if (s) pred[bk.slot] += extend(br.get(s), s);
          bk.coef[0] = (int16_t)(pred[bk.slot] * (1 << al));
        } else if (br.get(1)) {
          bk.coef[0] = (int16_t)(bk.coef[0] | (1 << al));
        }
      }
    }
    (void)ns;
  }

  static void ac_first(Bits& br, std::vector<std::vector<Block>>& mcus, size_t lo, size_t hi, const Huff& t, int ss,
                       int se, int al) {
    int eobrun = 0;
    for (size_t m = lo; m < hi; ++m) {
      int16_t* coef = mcus[m][0].coef;
      if (eobrun) {
        --eobrun;
        continue;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = decode_symbol(br, t);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          coef[natural(k)] = (int16_t)(extend(br.get(s), s) * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
          break;
        }
      }
    }
  }

  static void ac_refine(Bits& br, std::vector<std::vector<Block>>& mcus, size_t lo, size_t hi, const Huff& t, int ss,
                        int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int eobrun = 0;
    for (size_t m = lo; m < hi; ++m) {
      int16_t* coef = mcus[m][0].coef;
      int k = ss;
      if (!eobrun) {
        for (; k <= se; ++k) {
          const int rs = decode_symbol(br, t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = (1 << r) + (r ? br.get(r) : 0);
            break;
          }
          while (k <= se) {
            int16_t* c = coef + natural(k);
            if (*c) {
              if (br.get(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
            } else if (--r < 0) {
              break;
            }
            ++k;
          }
          if (s) coef[natural(k)] = (int16_t)s;
        }
      }
      if (eobrun) {
        for (; k <= se; ++k) {
          int16_t* c = coef + natural(k);
          if (*c && br.get(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
        }
        --eobrun;
      }
    }
  }
};

// decode one stream's entropy-coded data into im; false (im.error set) on failure
inline bool entropy_decode(const uint8_t* data, size_t len, Image& im) {
  try {
    Decoder(data, len, im).run();
    return true;
  } catch (const Error& e) {
    im.error = e.what;
  } catch (const std::exception& e) {
    im.error = std::string("decode failed: ") + e.what();
  }
  return false;
}

}  // namespace jx
