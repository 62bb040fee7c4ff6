// Host decoders of the port's input pipeline, with no library: plain C
// entry points, loaded with ctypes (which releases the GIL for each call,
// so the loader's threads decode in parallel).
//
// Formats:
//   .flo  Middlebury flow (magic 202021.25)
//   .ppm  binary P5 / P6, maxval <= 255 (FlyingChairs frames)
//   .png  the caller walks the chunks and inflates the IDAT stream (Python's
//         zlib); this file undoes the five row filters and normalizes the
//         pixels as libpng does with palette -> RGB, gray of 1/2/4 bits -> 8
//         bits and tRNS -> alpha: gray 1, gray+alpha 2, RGB 3, RGBA 4
//         channels (palette: 3, or 4 with tRNS), 8 or 16 bits per sample,
//         16-bit samples in host order; interlaced (Adam7) images are
//         unfiltered pass by pass and scattered into place;
//   .jpg  baseline JPEG (SOF0, SOF1; Huffman; 8-bit; gray or three
//         components; DRI restarts; 4:4:4, 4:2:2, 4:2:0), decoded with
//         libjpeg's arithmetic (jidctint.c's integer IDCT, jdsample.c's
//         fancy upsampling, jdcolor.c's fixed-point YCbCr -> RGB), so the
//         pixels equal libjpeg-turbo's (JDCT_ISLOW, fancy upsampling on).
//         Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
//         four-component files and other sampling factors are refused with
//         a code of their own.
//
// Every function returns 0 on success and a negative code otherwise; probes
// report the dimensions, so Python allocates the numpy output and the decode
// writes straight into it.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

// Skip PPM whitespace and comments. Returns the next position or -1.
int64_t ppm_skip(const uint8_t* buf, int64_t len, int64_t p) {
  while (p < len) {
    if (buf[p] == '#') {
      while (p < len && buf[p] != '\n') p++;
    } else if (buf[p] == ' ' || buf[p] == '\t' || buf[p] == '\r' ||
               buf[p] == '\n') {
      p++;
    } else {
      return p;
    }
  }
  return -1;
}

int64_t ppm_int(const uint8_t* buf, int64_t len, int64_t p, int* out) {
  p = ppm_skip(buf, len, p);
  if (p < 0) return -1;
  int v = 0;
  bool any = false;
  while (p < len && buf[p] >= '0' && buf[p] <= '9') {
    v = v * 10 + (buf[p] - '0');
    p++;
    any = true;
  }
  if (!any) return -1;
  *out = v;
  return p;
}

struct PpmHeader {
  int w, h, maxval, channels;
  int64_t data_off;
};

int ppm_parse(const uint8_t* buf, int64_t len, PpmHeader* hdr) {
  if (len < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) return -1;
  hdr->channels = buf[1] == '6' ? 3 : 1;
  int64_t p = 2;
  p = ppm_int(buf, len, p, &hdr->w);
  if (p < 0) return -2;
  p = ppm_int(buf, len, p, &hdr->h);
  if (p < 0) return -2;
  p = ppm_int(buf, len, p, &hdr->maxval);
  if (p < 0 || hdr->maxval > 255) return -3;
  // exactly one whitespace byte after maxval; anything else would shift
  // every pixel by a byte, so fail instead
  if (p >= len || !(buf[p] == ' ' || buf[p] == '\t' || buf[p] == '\n' ||
                    buf[p] == '\r' || buf[p] == '\v' || buf[p] == '\f'))
    return -5;
  hdr->data_off = p + 1;
  int64_t need = (int64_t)hdr->w * hdr->h * hdr->channels;
  if (hdr->data_off + need > len) return -4;
  return 0;
}

// ---- PNG ---------------------------------------------------------------------

struct Png {
  int32_t w, h, depth, color, interlace;
  const uint8_t* plte;  // nplte RGB triples
  int32_t nplte;
  const uint8_t* trns;  // the tRNS chunk's bytes
  int32_t ntrns;
};

int png_samples(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

// The checks libpng makes on IHDR's depth and colour type, and on PLTE.
int png_valid(const Png& p) {
  if (p.w <= 0 || p.h <= 0) return -2;
  int d = p.depth;
  switch (p.color) {
    case 0: if (d != 1 && d != 2 && d != 4 && d != 8 && d != 16) return -2; break;
    case 3: if (d != 1 && d != 2 && d != 4 && d != 8) return -2;
            if (p.nplte <= 0 || p.nplte > 256) return -6;
            break;
    case 2: case 4: case 6: if (d != 8 && d != 16) return -2; break;
    default: return -2;
  }
  return 0;
}

// Channels after normalization (see the file's header).
int png_channels(const Png& p) {
  switch (p.color) {
    case 0: return p.ntrns > 0 ? 2 : 1;
    case 2: return p.ntrns > 0 ? 4 : 3;
    case 3: return p.ntrns > 0 ? 4 : 3;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

int64_t png_row_bytes(const Png& p, int64_t w) {
  return (w * png_samples(p.color) * p.depth + 7) / 8;
}

// Adam7: pass k covers the pixels (y0 + i*dy, x0 + j*dx).
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                              {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                              {0, 1, 1, 2}};  // x0, y0, dx, dy

inline int64_t pass_extent(int64_t n, int start, int step) {
  return n > start ? (n - start + step - 1) / step : 0;
}

inline uint8_t paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Undo one row's filter in place. prior: the previous unfiltered row (zeros
// for the first row), bpp: bytes per complete pixel, at least 1.
int unfilter_row(int type, uint8_t* row, const uint8_t* prior, int64_t n,
                 int bpp) {
  switch (type) {
    case 0:
      return 0;
    case 1:  // Sub
      for (int64_t i = bpp; i < n; i++) row[i] = (uint8_t)(row[i] + row[i - bpp]);
      return 0;
    case 2:  // Up
      for (int64_t i = 0; i < n; i++) row[i] = (uint8_t)(row[i] + prior[i]);
      return 0;
    case 3:  // Average
      for (int64_t i = 0; i < bpp && i < n; i++)
        row[i] = (uint8_t)(row[i] + (prior[i] >> 1));
      for (int64_t i = bpp; i < n; i++)
        row[i] = (uint8_t)(row[i] + ((row[i - bpp] + prior[i]) >> 1));
      return 0;
    case 4:  // Paeth
      for (int64_t i = 0; i < bpp && i < n; i++)
        row[i] = (uint8_t)(row[i] + paeth(0, prior[i], 0));
      for (int64_t i = bpp; i < n; i++)
        row[i] = (uint8_t)(row[i] + paeth(row[i - bpp], prior[i], prior[i - bpp]));
      return 0;
  }
  return -7;  // unknown filter type
}

inline int sample_at(const uint8_t* row, int64_t i, int depth) {
  // the i-th sample of a row of 1/2/4/8-bit samples, MSB first
  if (depth == 8) return row[i];
  int64_t bit = i * depth;
  int shift = 8 - depth - (int)(bit & 7);
  return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
}

// One unfiltered row of w pixels -> normalized pixels (uint8 or host-order
// uint16).
void normalize_row(const Png& p, int64_t w, const uint8_t* row, uint8_t* out8,
                   uint16_t* out16) {
  const int ch = png_channels(p);
  if (p.depth == 16) {
    const int ns = png_samples(p.color);
    int trns[3] = {-1, -1, -1};
    for (int k = 0; k < 3 && 2 * k + 1 < p.ntrns; k++)
      trns[k] = (p.trns[2 * k] << 8) | p.trns[2 * k + 1];
    for (int64_t x = 0; x < w; x++) {
      const uint8_t* s = row + x * ns * 2;
      uint16_t* o = out16 + x * ch;
      bool opaque = false;
      for (int k = 0; k < ns; k++) {
        o[k] = (uint16_t)((s[2 * k] << 8) | s[2 * k + 1]);
        if (ch > ns && o[k] != trns[k]) opaque = true;
      }
      if (ch > ns) o[ns] = opaque ? 65535 : 0;
    }
    return;
  }
  if (p.color == 3) {
    for (int64_t x = 0; x < w; x++) {
      int idx = sample_at(row, x, p.depth);
      uint8_t* o = out8 + x * ch;
      // an index past the palette reads black, as libpng does
      if (idx < p.nplte) {
        std::memcpy(o, p.plte + 3 * idx, 3);
      } else {
        o[0] = o[1] = o[2] = 0;
      }
      if (ch == 4) o[3] = idx < p.ntrns ? p.trns[idx] : 255;
    }
    return;
  }
  if (p.color == 0) {
    const int scale = p.depth == 8 ? 1 : 255 / ((1 << p.depth) - 1);
    const int key = p.ntrns >= 2 ? ((p.trns[0] << 8) | p.trns[1]) : -1;
    for (int64_t x = 0; x < w; x++) {
      int v = sample_at(row, x, p.depth);
      out8[x * ch] = (uint8_t)(v * scale);
      if (ch == 2) out8[x * ch + 1] = v == key ? 0 : 255;
    }
    return;
  }
  if (p.color == 2 && ch == 4) {
    int key[3] = {-1, -1, -1};
    for (int k = 0; k < 3 && 2 * k + 1 < p.ntrns; k++)
      key[k] = (p.trns[2 * k] << 8) | p.trns[2 * k + 1];
    for (int64_t x = 0; x < w; x++) {
      const uint8_t* s = row + 3 * x;
      uint8_t* o = out8 + 4 * x;
      o[0] = s[0], o[1] = s[1], o[2] = s[2];
      o[3] = (s[0] == key[0] && s[1] == key[1] && s[2] == key[2]) ? 0 : 255;
    }
    return;
  }
  std::memcpy(out8, row, (size_t)w * ch);  // gray+alpha, RGB, RGBA
}

// Walk the inflated stream row by row up to row `rows`, calling emit(y,
// normalized row) for each. The stream is (filter byte, row bytes) per row.
template <typename Emit>
int png_rows(const Png& p, const uint8_t* z, int64_t zlen, int32_t rows,
             Emit emit) {
  int rc = png_valid(p);
  if (rc) return rc;
  const int64_t n = png_row_bytes(p, p.w);
  if (zlen < (n + 1) * (int64_t)p.h) return -8;  // stream too short
  const int bpp = std::max(1, png_samples(p.color) * p.depth / 8);
  const int ch = png_channels(p);
  std::vector<uint8_t> prior(n, 0), cur(n);
  std::vector<uint8_t> out8(p.depth == 16 ? 0 : (size_t)p.w * ch);
  std::vector<uint16_t> out16(p.depth == 16 ? (size_t)p.w * ch : 0);
  for (int32_t y = 0; y < rows; y++) {
    const uint8_t* src = z + y * (n + 1);
    std::memcpy(cur.data(), src + 1, n);
    rc = unfilter_row(src[0], cur.data(), prior.data(), n, bpp);
    if (rc) return rc;
    normalize_row(p, p.w, cur.data(), out8.data(), out16.data());
    emit(y, out8.data(), out16.data());
    std::swap(prior, cur);
  }
  return 0;
}

// An interlaced image, whole: each of the seven passes is a small image of
// its own (its own row width, filters reset to a zero prior row, no bytes at
// all where it is empty), unfiltered and normalized row by row and scattered
// into out (h*w*channels uint8 or uint16 elements).
int png_adam7(const Png& p, const uint8_t* z, int64_t zlen, void* out) {
  int rc = png_valid(p);
  if (rc) return rc;
  const int ch = png_channels(p);
  const int bpp = std::max(1, png_samples(p.color) * p.depth / 8);
  int64_t need = 0;
  for (const auto& a : kAdam7) {
    const int64_t pw = pass_extent(p.w, a[0], a[2]), ph = pass_extent(p.h, a[1], a[3]);
    if (pw && ph) need += ph * (png_row_bytes(p, pw) + 1);
  }
  if (zlen < need) return -8;
  const size_t row = (size_t)p.w * ch;
  std::vector<uint8_t> out8((size_t)(p.depth == 16 ? 0 : p.w * ch));
  std::vector<uint16_t> out16((size_t)(p.depth == 16 ? p.w * ch : 0));
  const uint8_t* src = z;
  for (const auto& a : kAdam7) {
    const int64_t pw = pass_extent(p.w, a[0], a[2]), ph = pass_extent(p.h, a[1], a[3]);
    if (!pw || !ph) continue;
    const int64_t n = png_row_bytes(p, pw);
    std::vector<uint8_t> prior(n, 0), cur(n);
    for (int64_t i = 0; i < ph; i++, src += n + 1) {
      std::memcpy(cur.data(), src + 1, n);
      rc = unfilter_row(src[0], cur.data(), prior.data(), n, bpp);
      if (rc) return rc;
      normalize_row(p, pw, cur.data(), out8.data(), out16.data());
      const int64_t y = a[1] + i * a[3];
      for (int64_t j = 0; j < pw; j++) {
        const int64_t x = a[0] + j * a[2];
        if (p.depth == 16) {
          std::memcpy(static_cast<uint16_t*>(out) + y * row + x * ch,
                      out16.data() + j * ch, ch * 2);
        } else {
          std::memcpy(static_cast<uint8_t*>(out) + y * row + x * ch,
                      out8.data() + j * ch, ch);
        }
      }
      std::swap(prior, cur);
    }
  }
  return 0;
}

// ---- JPEG (baseline) -----------------------------------------------------------
//
// The whole file is parsed first: every scan's Huffman data is decoded into
// per-component coefficient blocks (so non-interleaved scans cost nothing
// extra); then each block goes through jidctint.c's integer IDCT, the
// chroma planes through jdsample.c's upsampling and the pixels through
// jdcolor.c's YCbCr -> RGB, each as libjpeg(-turbo) computes it.

enum JpegError {
  kJpegNotJpeg = -20,
  kJpegProgressive = -21,
  kJpegArithmetic = -22,
  kJpegLossless = -23,    // lossless or hierarchical (SOF3, SOF5-7, SOF11, 13-15)
  kJpegPrecision = -24,   // sample precision other than 8 bits
  kJpegComponents = -25,  // not 1 or 3 components (CMYK, YCCK)
  kJpegSampling = -26,    // sampling factors other than 4:4:4, 4:2:2, 4:2:0
  kJpegCorrupt = -27,
  kJpegTruncated = -28,
  kJpegNoFrame = -29,
  kJpegTooLarge = -30,  // its coefficients do not fit in memory
};

// zigzag position -> natural (row-major) index, with 16 spare entries as in
// libjpeg (a corrupt run past 63 lands on 63)
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};    // largest code of each length, -1 if none
  int32_t valoffset[18] = {};  // vals index = code + valoffset[length]
  uint8_t look_len[1 << kLookBits] = {};  // 0: longer than kLookBits
  uint8_t look_sym[1 << kLookBits] = {};
};

// jdhuff.c's jpeg_make_d_derived_tbl
int huffman_build(const uint8_t* counts, const uint8_t* vals, int nvals,
                  Huffman* t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = (uint8_t)l;
  size[p] = 0;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return kJpegCorrupt;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      t->valoffset[l] = p - (int32_t)code[p];
      p += counts[l - 1];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, vals, nvals);
  std::memset(t->look_len, 0, sizeof(t->look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      const int look = (int)code[p] << (kLookBits - l);
      for (int k = 0; k < (1 << (kLookBits - l)); k++) {
        t->look_len[look + k] = (uint8_t)l;
        t->look_sym[look + k] = vals[p];
      }
    }
  }
  t->defined = true;
  return 0;
}

// The entropy-coded bits of one scan: byte stuffing undone, and zeros fed
// once a marker is reached (libjpeg's behaviour on a short segment).
struct BitReader {
  const uint8_t* buf;
  int64_t len, pos;
  uint64_t acc = 0;
  int nbits = 0;

  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (pos < len) {
        b = buf[pos];
        if (b == 0xFF) {
          const uint8_t next = pos + 1 < len ? buf[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            b = 0;  // a marker: stay on it, feed zeros
          }
        } else {
          pos++;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  int bits(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (nbits < n) fill();
    nbits -= n;
    return (int)((acc >> nbits) & ((1u << n) - 1));
  }
  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    const int look = (int)((acc >> (nbits - kLookBits)) & ((1 << kLookBits) - 1));
    if (const int l = t.look_len[look]) {
      nbits -= l;
      return t.look_sym[look];
    }
    const int32_t code16 = (int32_t)((acc >> (nbits - 16)) & 0xFFFF);
    for (int l = kLookBits + 1; l <= 16; l++) {
      const int32_t c = code16 >> (16 - l);
      if (c <= t.maxcode[l]) {
        nbits -= l;
        return t.vals[(c + t.valoffset[l]) & 0xFF];
      }
    }
    return -1;  // no such code
  }
  void reset() { acc = 0, nbits = 0; }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct JpegComponent {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int64_t width, height;    // downsampled_width / _height
  int64_t bw, bh;           // blocks allocated: whole MCUs
  int64_t wblocks, hblocks;  // blocks that hold samples
  bool scanned = false;
  uint16_t quant[64] = {};   // latched at the component's first scan
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
};

struct Jpeg {
  int32_t w = 0, h = 0;
  int ncomp = 0, hmax = 1, vmax = 1;
  bool rgb = false;  // stored as RGB: no colour conversion
  JpegComponent comp[3];
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int jpeg_frame(Jpeg* j, const uint8_t* seg, int n) {
  if (n < 6) return kJpegCorrupt;
  if (seg[0] != 8) return kJpegPrecision;
  j->h = be16(seg + 1);
  j->w = be16(seg + 3);
  j->ncomp = seg[5];
  if (j->w <= 0 || j->h <= 0) return kJpegCorrupt;  // DNL-defined heights too
  if (j->ncomp != 1 && j->ncomp != 3) return kJpegComponents;
  if (n < 6 + 3 * j->ncomp) return kJpegCorrupt;
  for (int c = 0; c < j->ncomp; c++) {
    JpegComponent& k = j->comp[c];
    k.id = seg[6 + 3 * c];
    k.h = seg[7 + 3 * c] >> 4;
    k.v = seg[7 + 3 * c] & 15;
    k.tq = seg[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return kJpegCorrupt;
    j->hmax = std::max(j->hmax, k.h);
    j->vmax = std::max(j->vmax, k.v);
  }
  const int64_t mcux = (j->w + 8 * j->hmax - 1) / (8 * j->hmax);
  const int64_t mcuy = (j->h + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->ncomp; c++) {
    JpegComponent& k = j->comp[c];
    // one component: its factors mean nothing (jdinput.c sets them to 1)
    if (j->ncomp == 1) k.h = k.v = j->hmax = j->vmax = 1;
    // jdsample.c: full size, h2v1 and h2v2 only
    const int rh = j->hmax / k.h, rv = j->vmax / k.v;
    if (j->hmax % k.h || j->vmax % k.v || rh > 2 || rv > rh) return kJpegSampling;
    k.width = ((int64_t)j->w * k.h + j->hmax - 1) / j->hmax;
    k.height = ((int64_t)j->h * k.v + j->vmax - 1) / j->vmax;
    k.wblocks = (k.width + 7) / 8;
    k.hblocks = (k.height + 7) / 8;
    if (j->ncomp == 1) {
      k.bw = k.wblocks, k.bh = k.hblocks;
    } else {
      k.bw = mcux * k.h, k.bh = mcuy * k.v;
    }
    k.coef.assign((size_t)(k.bw * k.bh * 64), 0);
  }
  return 0;
}

// jdapimin.c's default_decompress_parms, from the markers seen before the
// first scan: three components are RGB (no conversion) under an Adobe
// marker with transform 0, or with the component ids 'R', 'G', 'B' and
// neither marker; YCbCr otherwise.
void jpeg_colorspace(Jpeg* j) {
  if (j->ncomp != 3 || j->jfif) {
    j->rgb = false;
  } else if (j->adobe) {
    j->rgb = j->adobe_transform == 0;
  } else {
    j->rgb = j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66;
  }
}

int jpeg_dht(Jpeg* j, const uint8_t* seg, int n) {
  int p = 0;
  while (p < n) {
    if (p + 17 > n) return kJpegCorrupt;
    const int tc = seg[p] >> 4, th = seg[p] & 15;
    if (tc > 1 || th > 3) return kJpegCorrupt;
    int total = 0;
    for (int i = 0; i < 16; i++) total += seg[p + 1 + i];
    if (total > 256 || p + 17 + total > n) return kJpegCorrupt;
    int rc = huffman_build(seg + p + 1, seg + p + 17, total, tc ? &j->ac[th] : &j->dc[th]);
    if (rc) return rc;
    p += 17 + total;
  }
  return 0;
}

int jpeg_dqt(Jpeg* j, const uint8_t* seg, int n) {
  int p = 0;
  while (p < n) {
    const int pq = seg[p] >> 4, tq = seg[p] & 15;
    if (pq > 1 || tq > 3 || p + 1 + 64 * (pq + 1) > n) return kJpegCorrupt;
    for (int i = 0; i < 64; i++)
      j->quant[tq][kNatural[i]] = pq ? (uint16_t)be16(seg + p + 1 + 2 * i) : seg[p + 1 + i];
    j->quant_defined[tq] = true;
    p += 1 + 64 * (pq + 1);
  }
  return 0;
}

int decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int* pred,
                 int16_t* blk) {
  int s = br.decode(dc);
  if (s < 0 || s > 16) return kJpegCorrupt;
  if (s) s = extend(br.bits(s), s);
  *pred += s;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; k++) {
    const int rs = br.decode(ac);
    if (rs < 0) return kJpegCorrupt;
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return 0;
}

// One scan from its SOS header (seg, n bytes); *pos: the entropy-coded data,
// left at the first byte after it.
int jpeg_scan(Jpeg* j, const uint8_t* seg, int n, const uint8_t* buf, int64_t len,
              int64_t* pos) {
  if (j->ncomp == 0) return kJpegNoFrame;
  if (n < 1) return kJpegCorrupt;
  const int ns = seg[0];
  if (ns < 1 || ns > j->ncomp || n < 1 + 2 * ns + 3) return kJpegCorrupt;
  JpegComponent* sc[3];
  for (int i = 0; i < ns; i++) {
    const int id = seg[1 + 2 * i];
    sc[i] = nullptr;
    for (int c = 0; c < j->ncomp; c++)
      if (j->comp[c].id == id) sc[i] = &j->comp[c];
    if (!sc[i]) return kJpegCorrupt;
    sc[i]->dc_tbl = seg[2 + 2 * i] >> 4;
    sc[i]->ac_tbl = seg[2 + 2 * i] & 15;
    if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3 || !j->dc[sc[i]->dc_tbl].defined ||
        !j->ac[sc[i]->ac_tbl].defined)
      return kJpegCorrupt;
    if (!sc[i]->scanned) {
      if (!j->quant_defined[sc[i]->tq]) return kJpegCorrupt;
      std::memcpy(sc[i]->quant, j->quant[sc[i]->tq], sizeof(sc[i]->quant));
      sc[i]->scanned = true;
    }
  }
  const int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns], ahl = seg[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahl != 0) return kJpegCorrupt;  // sequential only
  // MCUs: one block of the component when it is alone in the scan
  int64_t mcux, mcuy;
  if (ns == 1) {
    mcux = sc[0]->wblocks, mcuy = sc[0]->hblocks;
  } else {
    mcux = (j->w + 8 * j->hmax - 1) / (8 * j->hmax);
    mcuy = (j->h + 8 * j->vmax - 1) / (8 * j->vmax);
  }
  BitReader br{buf, len, *pos};
  int pred[3] = {0, 0, 0};
  int64_t left = j->restart;
  const int64_t total = mcux * mcuy;
  int next_rst = 0;
  for (int64_t m = 0; m < total; m++) {
    if (j->restart && left == 0) {
      // jdhuff.c's process_restart: drop the buffered bits, pass RSTn
      br.reset();
      int64_t q = br.pos;
      while (q < len && buf[q] != 0xFF) q++;  // skip what a short segment left
      while (q + 1 < len && buf[q] == 0xFF && buf[q + 1] == 0xFF) q++;
      if (q + 1 >= len) return kJpegTruncated;
      if (buf[q + 1] != 0xD0 + next_rst) return kJpegCorrupt;
      br.pos = q + 2;
      next_rst = (next_rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = 0;
      left = j->restart;
    }
    const int64_t mx = m % mcux, my = m / mcux;
    for (int i = 0; i < ns; i++) {
      JpegComponent& k = *sc[i];
      const Huffman& dc = j->dc[k.dc_tbl];
      const Huffman& ac = j->ac[k.ac_tbl];
      const int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
      for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bwid; bx++) {
          const int64_t row = my * bh + by, col = mx * bwid + bx;
          int16_t* blk = k.coef.data() + (row * k.bw + col) * 64;
          int rc = decode_block(br, dc, ac, &pred[i], blk);
          if (rc) return rc;
        }
      }
    }
    if (j->restart) left--;
  }
  // the scan's end: the next marker (bytes the last MCU did not need are
  // padding)
  int64_t q = br.pos;
  while (q + 1 < len && !(buf[q] == 0xFF && buf[q + 1] != 0 && buf[q + 1] != 0xFF &&
                          (buf[q + 1] < 0xD0 || buf[q + 1] > 0xD7)))
    q++;
  *pos = q;
  return 0;
}

// jidctint.c (libjpeg-turbo): CONST_BITS 13, PASS1_BITS 2; the output
// range-limited with libjpeg's table: idx = x & 1023 (RANGE_MASK),
// 0..127 -> x + 128, 128..511 -> 255, 512..895 -> 0, 896..1023 -> x - 896.
inline uint8_t idct_limit(int64_t x) {
  const int m = (int)(x & 1023);
  if (m < 128) return (uint8_t)(m + 128);
  if (m < 512) return 255;
  if (m < 896) return 0;
  return (uint8_t)(m - 896);
}

constexpr int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                  F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                  F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = (ip[0] * qp[0]) * 4;  // << PASS1_BITS
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847, tmp3 = z1 + z2 * F_0_765;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                  t12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298, tmp1 *= F_2_053, tmp2 *= F_3_072, tmp3 *= F_1_501;
    z1 *= -F_0_899, z2 *= -F_2_562, z3 *= -F_1_961, z4 *= -F_0_390;
    z3 += z5, z4 += z5;
    tmp0 += z1 + z3, tmp1 += z2 + z4, tmp2 += z2 + z3, tmp3 += z1 + z4;
    wp[0] = (int)descale(t10 + tmp3, 11);
    wp[56] = (int)descale(t10 - tmp3, 11);
    wp[8] = (int)descale(t11 + tmp2, 11);
    wp[48] = (int)descale(t11 - tmp2, 11);
    wp[16] = (int)descale(t12 + tmp1, 11);
    wp[40] = (int)descale(t12 - tmp1, 11);
    wp[24] = (int)descale(t13 + tmp0, 11);
    wp[32] = (int)descale(t13 - tmp0, 11);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = idct_limit(descale(wp[0], 5));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847, tmp3 = z1 + z2 * F_0_765;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * 8192, tmp1 = ((int64_t)wp[0] - wp[4]) * 8192;
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                  t12 = tmp1 - tmp2;
    tmp0 = wp[7], tmp1 = wp[5], tmp2 = wp[3], tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298, tmp1 *= F_2_053, tmp2 *= F_3_072, tmp3 *= F_1_501;
    z1 *= -F_0_899, z2 *= -F_2_562, z3 *= -F_1_961, z4 *= -F_0_390;
    z3 += z5, z4 += z5;
    tmp0 += z1 + z3, tmp1 += z2 + z4, tmp2 += z2 + z3, tmp3 += z1 + z4;
    op[0] = idct_limit(descale(t10 + tmp3, 18));
    op[7] = idct_limit(descale(t10 - tmp3, 18));
    op[1] = idct_limit(descale(t11 + tmp2, 18));
    op[6] = idct_limit(descale(t11 - tmp2, 18));
    op[2] = idct_limit(descale(t12 + tmp1, 18));
    op[5] = idct_limit(descale(t12 - tmp1, 18));
    op[3] = idct_limit(descale(t13 + tmp0, 18));
    op[4] = idct_limit(descale(t13 - tmp0, 18));
  }
}

// A component's samples, [height, width] with row stride bw * 8.
std::vector<uint8_t> component_plane(const JpegComponent& k) {
  const int64_t stride = k.bw * 8;
  std::vector<uint8_t> plane((size_t)(stride * k.hblocks * 8));
  for (int64_t by = 0; by < k.hblocks; by++)
    for (int64_t bx = 0; bx < k.wblocks; bx++)
      idct_islow(k.coef.data() + (by * k.bw + bx) * 64, k.quant,
                   plane.data() + by * 8 * stride + bx * 8, stride);
  return plane;
}

// jdsample.c: one row of a component upsampled 2x horizontally, fancy
// (triangle, weights 3/4 1/4) when the row holds more than 2 samples, else
// replicated.
void h2v1_row(const uint8_t* in, int64_t n, uint8_t* out) {
  if (n <= 2) {
    for (int64_t i = 0; i < n; i++) out[2 * i] = out[2 * i + 1] = in[i];
    return;
  }
  out[0] = in[0];
  out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
  for (int64_t i = 1; i < n - 1; i++) {
    const int v = in[i] * 3;
    out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
  }
  out[2 * n - 2] = (uint8_t)((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
  out[2 * n - 1] = in[n - 1];
}

// h2v2_fancy_upsample: output row 2r + v from input rows r (weight 3) and r
// - 1 (v = 0) or r + 1 (v = 1), the edge rows duplicated, then 3/4 1/4
// across columns with libjpeg's rounding (8 and 7 in turns).
void h2v2_row(const uint8_t* in0, const uint8_t* in1, int64_t n, uint8_t* out) {
  if (n <= 2) {  // h2v2_upsample: replicated
    for (int64_t i = 0; i < n; i++) out[2 * i] = out[2 * i + 1] = in0[i];
    return;
  }
  int this_sum = in0[0] * 3 + in1[0], next_sum = in0[1] * 3 + in1[1];
  out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
  out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int64_t i = 1; i < n - 1; i++) {
    next_sum = in0[i + 1] * 3 + in1[i + 1];
    out[2 * i] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * i + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * n - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * n - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
}

// jdcolor.c's tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = 1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t clamp255(int v) { return (uint8_t)std::min(255, std::max(0, v)); }

int jpeg_parse(const uint8_t* buf, int64_t len, Jpeg* j, bool headers_only) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kJpegNotJpeg;
  int64_t pos = 2;
  int scans = 0;
  while (true) {
    while (pos < len && buf[pos] != 0xFF) pos++;  // garbage before a marker
    while (pos < len && buf[pos] == 0xFF) pos++;  // fill bytes
    if (pos >= len) return headers_only && j->ncomp ? 0 : kJpegTruncated;
    const int marker = buf[pos++];
    if (marker == 0xD9) break;  // EOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;  // TEM, RSTn
    if (pos + 2 > len) return kJpegTruncated;
    const int n = be16(buf + pos) - 2;
    const uint8_t* seg = buf + pos + 2;
    if (n < 0 || pos + 2 + n > len) return kJpegTruncated;
    pos += 2 + n;
    int rc = 0;
    switch (marker) {
      case 0xC0: case 0xC1:
        if (j->ncomp) return kJpegCorrupt;  // a second frame
        rc = jpeg_frame(j, seg, n);
        if (!rc && headers_only) return 0;
        break;
      case 0xC2: case 0xC6: case 0xCA: case 0xCE: return kJpegProgressive;
      case 0xC9: case 0xCC: return kJpegArithmetic;
      case 0xC3: case 0xC5: case 0xC7: case 0xCB: case 0xCD: case 0xCF:
        return kJpegLossless;
      case 0xC4: rc = jpeg_dht(j, seg, n); break;
      case 0xDB: rc = jpeg_dqt(j, seg, n); break;
      case 0xDD:
        if (n < 2) return kJpegCorrupt;
        j->restart = be16(seg);
        break;
      case 0xDA:
        if (!scans++) jpeg_colorspace(j);
        rc = jpeg_scan(j, seg, n, buf, len, &pos);
        break;
      case 0xE0:  // jdmarker.c's examine_app0
        if (n >= 14 && !std::memcmp(seg, "JFIF\0", 5)) j->jfif = true;
        break;
      case 0xEE:  // examine_app14
        if (n >= 12 && !std::memcmp(seg, "Adobe", 5)) {
          j->adobe = true;
          j->adobe_transform = seg[11];
        }
        break;
      case 0xDC: return kJpegCorrupt;  // DNL: heights defined after the scan
      default: break;  // APPn, COM, DHP, EXP...: skipped
    }
    if (rc) return rc;
  }
  if (!j->ncomp) return kJpegNoFrame;
  if (headers_only) return 0;
  for (int c = 0; c < j->ncomp; c++)
    if (!j->comp[c].scanned) return kJpegCorrupt;
  return 0;
}

// The decoded image: out holds h*w*ncomp uint8 (RGB, or gray).
int jpeg_output(const Jpeg& j, uint8_t* out) {
  const int64_t w = j.w, h = j.h;
  if (j.ncomp == 1) {
    const JpegComponent& k = j.comp[0];
    std::vector<uint8_t> plane = component_plane(k);
    for (int64_t y = 0; y < h; y++)
      std::memcpy(out + y * w, plane.data() + y * k.bw * 8, (size_t)w);
    return 0;
  }
  static const YccTables t;
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < 3; c++) planes[c] = component_plane(j.comp[c]);
  // each component's row for output row y, upsampled to full width
  std::vector<uint8_t> rows[3];
  for (int c = 0; c < 3; c++) rows[c].resize((size_t)(j.comp[c].width * 2 + 16));
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* px[3];
    for (int c = 0; c < 3; c++) {
      const JpegComponent& k = j.comp[c];
      const int64_t stride = k.bw * 8;
      const int rh = j.hmax / k.h, rv = j.vmax / k.v;
      if (rv == 2) {
        const int64_t r = y / 2;
        const int64_t other = (y & 1) ? std::min(r + 1, k.height - 1) : std::max<int64_t>(r - 1, 0);
        h2v2_row(planes[c].data() + r * stride, planes[c].data() + other * stride, k.width,
                 rows[c].data());
        px[c] = rows[c].data();
      } else if (rh == 2) {
        h2v1_row(planes[c].data() + y * stride, k.width, rows[c].data());
        px[c] = rows[c].data();
      } else {
        px[c] = planes[c].data() + y * stride;
      }
    }
    uint8_t* o = out + y * w * 3;
    if (j.rgb) {
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = px[0][x], o[3 * x + 1] = px[1][x], o[3 * x + 2] = px[2][x];
      }
      continue;
    }
    for (int64_t x = 0; x < w; x++) {
      const int yy = px[0][x], cb = px[1][x], cr = px[2][x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// ---- .flo --------------------------------------------------------------------

int flo_probe(const uint8_t* buf, int64_t len, int32_t* w, int32_t* h) {
  if (len < 12) return -1;
  float magic;
  std::memcpy(&magic, buf, 4);
  if (magic != kFloMagic) return -2;
  std::memcpy(w, buf + 4, 4);
  std::memcpy(h, buf + 8, 4);
  if (*w <= 0 || *h <= 0 || 12 + (int64_t)*w * *h * 8 > len) return -3;
  return 0;
}

int flo_decode(const uint8_t* buf, int64_t len, float* out) {
  int32_t w, h;
  int rc = flo_probe(buf, len, &w, &h);
  if (rc) return rc;
  std::memcpy(out, buf + 12, (size_t)w * h * 8);
  return 0;
}

// ---- .ppm / .pgm ---------------------------------------------------------------

int ppm_probe(const uint8_t* buf, int64_t len, int32_t* w, int32_t* h,
              int32_t* channels) {
  PpmHeader hdr;
  int rc = ppm_parse(buf, len, &hdr);
  if (rc) return rc;
  *w = hdr.w;
  *h = hdr.h;
  *channels = hdr.channels;
  return 0;
}

int ppm_decode(const uint8_t* buf, int64_t len, uint8_t* out) {
  PpmHeader hdr;
  int rc = ppm_parse(buf, len, &hdr);
  if (rc) return rc;
  std::memcpy(out, buf + hdr.data_off, (size_t)hdr.w * hdr.h * hdr.channels);
  return 0;
}

// ---- .png ----------------------------------------------------------------------

// Channels of the normalized image, or a negative code for an IHDR libpng
// refuses.
int png_out_channels(int32_t w, int32_t h, int32_t depth, int32_t color,
                     int32_t nplte, int32_t ntrns) {
  Png p{w, h, depth, color, 0, nullptr, nplte, nullptr, ntrns};
  int rc = png_valid(p);
  return rc ? rc : png_channels(p);
}

// The whole image: out holds h*w*channels uint8 (depth <= 8) or uint16
// (depth 16) elements. interlace: 0 none, 1 Adam7.
int png_unfilter(const uint8_t* z, int64_t zlen, int32_t w, int32_t h,
                 int32_t depth, int32_t color, int32_t interlace,
                 const uint8_t* plte, int32_t nplte, const uint8_t* trns,
                 int32_t ntrns, void* out) {
  Png p{w, h, depth, color, interlace, plte, nplte, trns, ntrns};
  if (interlace) return png_adam7(p, z, zlen, out);
  const size_t row = (size_t)w * png_channels(p);
  return png_rows(p, z, zlen, h, [&](int32_t y, const uint8_t* r8,
                                     const uint16_t* r16) {
    if (depth == 16) {
      std::memcpy(static_cast<uint16_t*>(out) + y * row, r16, row * 2);
    } else {
      std::memcpy(static_cast<uint8_t*>(out) + y * row, r8, row);
    }
  });
}

// ---- fused decode + centre crop + normalize ------------------------------------
//
// dst[(y*tw + x) * pix_stride + c] = src[y0+y, x0+x, c] * scale + offset for
// c < 3, with y0 = (h-th)/2, x0 = (w-tw)/2 (the datasets' centre crop), in
// one pass, so the Python side does no per-pixel work. 8-bit images of 3 or
// more channels only; -10 for anything else (the caller takes the generic
// path; interlaced images too, as the JAX package's fused decode sends them
// there), -11 if the crop exceeds the image. Rows below the crop are never
// unfiltered.

int png_decode_norm_f32(const uint8_t* z, int64_t zlen, int32_t w, int32_t h,
                        int32_t depth, int32_t color, int32_t interlace,
                        const uint8_t* plte, int32_t nplte, const uint8_t* trns,
                        int32_t ntrns, float* dst, int64_t pix_stride,
                        int32_t th, int32_t tw, float scale, float offset) {
  Png p{w, h, depth, color, interlace, plte, nplte, trns, ntrns};
  int rc = png_valid(p);
  if (rc) return rc;
  const int ch = png_channels(p);
  if (depth == 16 || ch < 3 || interlace) return -10;
  if (th > h || tw > w) return -11;
  const int64_t y0 = (h - th) / 2, x0 = (w - tw) / 2;
  return png_rows(p, z, zlen, (int32_t)(y0 + th), [&](int32_t y,
                                                       const uint8_t* r8,
                                                       const uint16_t*) {
    if (y < y0) return;
    const uint8_t* src = r8 + x0 * ch;
    float* drow = dst + (y - y0) * tw * pix_stride;
    for (int64_t x = 0; x < tw; x++) {
      drow[x * pix_stride + 0] = src[x * ch + 0] * scale + offset;
      drow[x * pix_stride + 1] = src[x * ch + 1] * scale + offset;
      drow[x * pix_stride + 2] = src[x * ch + 2] * scale + offset;
    }
  });
}

int ppm_decode_norm_f32(const uint8_t* buf, int64_t len, float* dst,
                        int64_t pix_stride, int32_t th, int32_t tw,
                        float scale, float offset) {
  PpmHeader hdr;
  int rc = ppm_parse(buf, len, &hdr);
  if (rc) return rc;
  if (hdr.channels != 3) return -10;
  if (th > hdr.h || tw > hdr.w) return -11;
  int64_t y0 = (hdr.h - th) / 2, x0 = (hdr.w - tw) / 2;
  for (int64_t y = 0; y < th; y++) {
    const uint8_t* src = buf + hdr.data_off + ((y0 + y) * hdr.w + x0) * 3;
    float* drow = dst + y * tw * pix_stride;
    for (int64_t x = 0; x < tw; x++) {
      drow[x * pix_stride + 0] = src[x * 3 + 0] * scale + offset;
      drow[x * pix_stride + 1] = src[x * 3 + 1] * scale + offset;
      drow[x * pix_stride + 2] = src[x * 3 + 2] * scale + offset;
    }
  }
  return 0;
}

// ---- .jpg ----------------------------------------------------------------------

// The frame's size and channels (1 gray, 3 RGB) from the markers up to SOF.
int jpeg_probe(const uint8_t* buf, int64_t len, int32_t* w, int32_t* h,
               int32_t* channels) {
  Jpeg j;
  int rc = jpeg_parse(buf, len, &j, true);
  if (rc) return rc;
  *w = j.w;
  *h = j.h;
  *channels = j.ncomp;
  return 0;
}

// The whole image: out holds h*w*channels uint8.
int jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out) {
  try {  // no exception may cross the C boundary
    Jpeg j;
    int rc = jpeg_parse(buf, len, &j, false);
    return rc ? rc : jpeg_output(j, out);
  } catch (const std::bad_alloc&) {
    return kJpegTooLarge;
  }
}

}  // extern "C"
