// Host decoders of the port's input pipeline, with no library: plain C
// entry points, loaded with ctypes (which releases the GIL for each call,
// so the loader's threads decode in parallel).
//
// Formats, each decoded to what the JAX package's read_gen returns:
//   .flo  Middlebury flow (magic 202021.25)
//   .ppm  binary P5 / P6, maxval <= 255, the bytes as stored (FlyingChairs
//         frames; the JAX package's own decoder); every other PNM as Pillow's
//         PpmImagePlugin reads it (16-bit, ASCII P1-P3, P4 bitmaps, Pf)
//   .png  the caller walks the chunks and inflates the IDAT stream (Python's
//         zlib); this file undoes the five row filters and normalizes the
//         pixels as libpng does with palette -> RGB, gray of 1/2/4 bits -> 8
//         bits and tRNS -> alpha: gray 1, gray+alpha 2, RGB 3, RGBA 4
//         channels (palette: 3, or 4 with tRNS), 8 or 16 bits per sample,
//         16-bit samples in host order; interlaced (Adam7) images are
//         unfiltered pass by pass and scattered into place;
//   .jpg  as Pillow decodes it through libjpeg-turbo 3.1.3 (JDCT_ISLOW,
//         fancy upsampling and block smoothing on): sequential and
//         progressive, Huffman- or arithmetic-coded (SOF0-2, SOF9-10, DAC)
//         and lossless (SOF3) frames of 1, 3 or 4 components at any
//         integral sampling ratio, with libjpeg's arithmetic throughout
//         (jidctint.c, jdcoefct.c's smoothing, jdsample.c, jdcolor.c, then
//         Pillow's inversion of four-component samples). What libjpeg or
//         Pillow refuses (12-bit, hierarchical, SOF11, 2 or 5+ components,
//         a ratio that is not an integer, ...) is refused with a code of its
//         own.
//
// Every function returns 0 on success and a negative code otherwise; probes
// report the dimensions, so Python allocates the numpy output and the decode
// writes straight into it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <utility>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;
// Pillow's Image.open refuses an image of more pixels (DecompressionBombError:
// twice Image.MAX_IMAGE_PIXELS), whatever its format
constexpr int64_t kPillowMaxPixels = 2 * 89478485LL;

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

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

// ---- PNM as Pillow reads it ----------------------------------------------------
//
// Everything the native P5 / P6 path above refuses goes where the JAX
// package's read_gen sends it: Pillow's PpmImagePlugin (12.1). Its rules,
// followed to the byte:
//   header  a magic of up to 6 bytes ended by whitespace; then tokens of at
//           most 10 bytes, '#' comments to CR or LF anywhere (a comment inside
//           a token joins its two halves), Python's int() / float() on each;
//           the data starts right after the byte that ended the last token;
//   P1      ASCII bits, whitespace optional, comments (with their end of
//           line) cut from the data -> bool, true where the bit is 0;
//   P4      packed bits, rows padded to a byte -> bool, the same way;
//   P2, P3  ASCII samples, each <= maxval, round(v / maxval * out_max) with
//           Python's round (half to even) -> uint8, or int32 (out_max
//           65535) for P2 with maxval > 255;
//   P5, P6  maxval 255: the bytes; P5 maxval 65535: the big-endian values as
//           int32; otherwise min(out_max, round(v / maxval * out_max)) from 1
//           or 2 bytes a sample, the same types as ASCII;
//   Pf      float32 samples, little-endian if the scale is negative, rows
//           stored bottom-up.
// The data is read in blocks of ImageFile.SAFEBLOCK bytes, as Pillow reads
// it, since where a block ends can decide whether a file raises.

enum PnmError {
  kPnmMagic = -40,    // not a magic Pillow reads
  kPnmPrivate = -41,  // Pillow's own P0CMYK, PyP, PyRGBA, PyCMYK
  kPnmHeader = -42,
  kPnmTruncated = -43,
  kPnmData = -44,     // an ASCII token Pillow refuses
  kPnmTooLarge = -45,  // past kPillowMaxPixels
};

enum PnmType { kPnmU8 = 0, kPnmI32 = 1, kPnmBool = 2, kPnmF32 = 3 };

constexpr int64_t kSafeBlock = 1 << 20;

inline bool pil_space(uint8_t c) {  // PpmImagePlugin.b_whitespace, bytes.split()'s
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r';
}

// Python's int() on the bytes of a token: a sign, digits, single underscores
// between digits.
bool py_int(const std::string& s, int64_t* out) {
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  if (i >= s.size()) return false;
  int64_t v = 0;
  bool digit = false;
  for (; i < s.size(); i++) {
    if (s[i] >= '0' && s[i] <= '9') {
      v = v * 10 + (s[i] - '0');  // at most 10 digits: no overflow
      digit = true;
    } else if (s[i] == '_' && digit && i + 1 < s.size() && s[i + 1] >= '0' && s[i + 1] <= '9') {
      digit = false;
    } else {
      return false;
    }
  }
  *out = neg ? -v : v;
  return true;
}

// Python's float() on a token (digits, sign, point, exponent, underscores
// between digits; inf and nan are refused anyway by the caller's check).
bool py_float(const std::string& s, double* out) {
  std::string t;
  for (size_t i = 0; i < s.size(); i++) {
    const char c = s[i];
    if (c == '_') {
      if (i == 0 || i + 1 >= s.size() || !isdigit((unsigned char)s[i - 1]) ||
          !isdigit((unsigned char)s[i + 1]))
        return false;
      continue;
    }
    if (!(isdigit((unsigned char)c) || c == '+' || c == '-' || c == '.' || c == 'e' ||
          c == 'E'))
      return false;
    t += c;
  }
  if (t.empty()) return false;
  char* end = nullptr;
  *out = std::strtod(t.c_str(), &end);
  return end == t.c_str() + t.size();
}

struct Pnm {
  char kind = 0;  // '1'..'6', or 'f'
  int64_t w = 0, h = 0, maxval = 0, data_off = 0;
  double scale = 0;
  int channels = 1, type = kPnmU8;
};

// PpmImageFile._read_token from *p.
int pil_token(const uint8_t* buf, int64_t len, int64_t* p, std::string* tok) {
  tok->clear();
  while (tok->size() <= 10) {
    if (*p >= len) break;
    const uint8_t c = buf[(*p)++];
    if (pil_space(c)) {
      if (tok->empty()) continue;
      break;
    }
    if (c == '#') {
      while (*p < len) {
        const uint8_t d = buf[(*p)++];
        if (d == '\r' || d == '\n') break;
      }
      continue;
    }
    *tok += (char)c;
  }
  if (tok->empty() || tok->size() > 10) return kPnmHeader;
  return 0;
}

int pnm_header(const uint8_t* buf, int64_t len, Pnm* m) {
  std::string magic;
  int64_t p = 0;
  for (int i = 0; i < 6 && p < len; i++) {
    const uint8_t c = buf[p++];
    if (pil_space(c)) break;
    magic += (char)c;
  }
  if (magic == "P0CMYK" || magic == "PyP" || magic == "PyRGBA" || magic == "PyCMYK")
    return kPnmPrivate;
  if (magic == "Pf") {
    m->kind = 'f';
  } else if (magic.size() == 2 && magic[0] == 'P' && magic[1] >= '1' && magic[1] <= '6') {
    m->kind = magic[1];
  } else {
    return kPnmMagic;
  }
  std::string tok;
  int rc;
  if ((rc = pil_token(buf, len, &p, &tok)) || !py_int(tok, &m->w)) return kPnmHeader;
  if ((rc = pil_token(buf, len, &p, &tok)) || !py_int(tok, &m->h)) return kPnmHeader;
  const char k = m->kind;
  m->channels = (k == '3' || k == '6') ? 3 : 1;
  if (k == '1' || k == '4') {
    m->type = kPnmBool;
  } else if (k == 'f') {
    if ((rc = pil_token(buf, len, &p, &tok)) || !py_float(tok, &m->scale) ||
        m->scale == 0.0 || !std::isfinite(m->scale))
      return kPnmHeader;
    m->type = kPnmF32;
  } else {
    if ((rc = pil_token(buf, len, &p, &tok)) || !py_int(tok, &m->maxval) ||
        m->maxval <= 0 || m->maxval >= 65536)
      return kPnmHeader;
    m->type = (m->maxval > 255 && m->channels == 1) ? kPnmI32 : kPnmU8;
  }
  // ImageFile refuses an empty size
  if (m->w <= 0 || m->h <= 0 || m->w > INT32_MAX || m->h > INT32_MAX) return kPnmHeader;
  if (m->w * m->h > kPillowMaxPixels) return kPnmTooLarge;
  m->data_off = p;
  return 0;
}

inline void pnm_store(const Pnm& m, void* out, int64_t i, int64_t v) {
  if (m.type == kPnmI32) {
    static_cast<int32_t*>(out)[i] = (int32_t)v;
  } else {
    static_cast<uint8_t*>(out)[i] = (uint8_t)v;
  }
}

// round(v / maxval * out_max), Python's round on the double
inline int64_t pnm_scale(int64_t v, int64_t maxval, int64_t out_max) {
  return (int64_t)std::nearbyint((double)v / (double)maxval * (double)out_max);
}

// PpmPlainDecoder: its blocks, comments and half tokens.
struct PlainReader {
  const uint8_t* buf;
  int64_t len, pos;
  bool comment_spans = false;

  std::string read_block() {
    const int64_t n = std::min(kSafeBlock, len - pos);
    std::string b(reinterpret_cast<const char*>(buf + pos), (size_t)std::max<int64_t>(n, 0));
    pos += std::max<int64_t>(n, 0);
    return b;
  }
  // _find_comment_end, with its quirk: min of the two ends only when their
  // product is positive
  static int64_t comment_end(const std::string& b, size_t start) {
    const size_t fa = b.find('\n', start), fb = b.find('\r', start);
    const int64_t a = fa == std::string::npos ? -1 : (int64_t)fa;
    const int64_t c = fb == std::string::npos ? -1 : (int64_t)fb;
    return a * c > 0 ? std::min(a, c) : std::max(a, c);
  }
  std::string ignore_comments(std::string block) {
    if (comment_spans) {
      while (!block.empty()) {
        const int64_t end = comment_end(block, 0);
        if (end != -1) {
          block = block.substr((size_t)end + 1);
          break;
        }
        block = read_block();
      }
    }
    comment_spans = false;
    while (true) {
      const size_t start = block.find('#');
      if (start == std::string::npos) break;
      const int64_t end = comment_end(block, start);
      if (end != -1) {
        block = block.substr(0, start) + block.substr((size_t)end + 1);
      } else {
        block = block.substr(0, start);
        comment_spans = true;
        break;
      }
    }
    return block;
  }
};

std::vector<std::string> py_split(const std::string& b) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < b.size()) {
    while (i < b.size() && pil_space((uint8_t)b[i])) i++;
    size_t j = i;
    while (j < b.size() && !pil_space((uint8_t)b[j])) j++;
    if (j > i) out.push_back(b.substr(i, j - i));
    i = j;
  }
  return out;
}

// _decode_bitonal
int pnm_plain_bits(const uint8_t* buf, int64_t len, const Pnm& m, uint8_t* out) {
  PlainReader rd{buf, len, m.data_off};
  const int64_t total = m.w * m.h;
  int64_t have = 0;
  while (have != total) {
    std::string block = rd.read_block();
    if (block.empty()) break;
    block = rd.ignore_comments(block);
    std::string bits;
    for (const std::string& t : py_split(block)) bits += t;
    for (char c : bits)
      if (c != '0' && c != '1') return kPnmData;
    for (size_t i = 0; i < bits.size() && have < total; i++) out[have++] = bits[i] == '0' ? 255 : 0;
  }
  return have == total ? 0 : kPnmTruncated;
}

// _decode_blocks
int pnm_plain_values(const uint8_t* buf, int64_t len, const Pnm& m, void* out) {
  PlainReader rd{buf, len, m.data_off};
  const int64_t out_max = m.type == kPnmI32 ? 65535 : 255;
  const int64_t total = m.w * m.h * m.channels;
  int64_t have = 0;
  std::string half;
  while (have != total) {
    std::string block = rd.read_block();
    if (block.empty()) {
      if (half.empty()) break;
      block = " ";  // flush the half token
    }
    block = rd.ignore_comments(block);
    if (!half.empty()) {
      block = half + block;
      half.clear();
    }
    std::vector<std::string> tokens = py_split(block);
    if (!block.empty() && !pil_space((uint8_t)block.back())) {
      half = tokens.back();
      tokens.pop_back();
      if (half.size() > 10) return kPnmData;
    }
    for (const std::string& t : tokens) {
      int64_t v;
      if (t.size() > 10 || !py_int(t, &v) || v < 0 || v > m.maxval) return kPnmData;
      pnm_store(m, out, have++, pnm_scale(v, m.maxval, out_max));
      if (have == total) break;
    }
  }
  return have == total ? 0 : kPnmTruncated;
}

int pnm_binary(const uint8_t* buf, int64_t len, const Pnm& m, void* out) {
  const uint8_t* d = buf + m.data_off;
  const int64_t avail = len - m.data_off;
  const int64_t n = m.w * m.h * m.channels;
  if (m.kind == '4') {  // raw "1;I"
    const int64_t row = (m.w + 7) / 8;
    if (avail < row * m.h) return kPnmTruncated;
    uint8_t* o = static_cast<uint8_t*>(out);
    for (int64_t y = 0; y < m.h; y++)
      for (int64_t x = 0; x < m.w; x++)
        o[y * m.w + x] = (d[y * row + x / 8] >> (7 - x % 8)) & 1 ? 0 : 255;
    return 0;
  }
  if (m.kind == 'f') {  // raw "F;32F" / "F;32BF", orientation -1
    if (avail < n * 4) return kPnmTruncated;
    float* o = static_cast<float*>(out);
    for (int64_t y = 0; y < m.h; y++) {
      for (int64_t x = 0; x < m.w; x++) {
        const uint8_t* s = d + ((m.h - 1 - y) * m.w + x) * 4;
        uint32_t u = m.scale < 0 ? (uint32_t)s[0] | (uint32_t)s[1] << 8 |
                                       (uint32_t)s[2] << 16 | (uint32_t)s[3] << 24
                                 : (uint32_t)s[3] | (uint32_t)s[2] << 8 |
                                       (uint32_t)s[1] << 16 | (uint32_t)s[0] << 24;
        std::memcpy(o + y * m.w + x, &u, 4);
      }
    }
    return 0;
  }
  if (m.maxval == 255) {  // raw "L" / "RGB"
    if (avail < n) return kPnmTruncated;
    std::memcpy(out, d, (size_t)n);
    return 0;
  }
  const int bytes = m.maxval < 256 ? 1 : 2;
  if (avail < n * bytes) return kPnmTruncated;
  if (m.kind == '5' && m.maxval == 65535) {  // raw "I;16B"
    for (int64_t i = 0; i < n; i++) pnm_store(m, out, i, be16(d + 2 * i));
    return 0;
  }
  const int64_t out_max = m.type == kPnmI32 ? 65535 : 255;  // PpmDecoder
  for (int64_t i = 0; i < n; i++) {
    const int64_t v = bytes == 1 ? d[i] : be16(d + 2 * i);
    pnm_store(m, out, i, std::min(out_max, pnm_scale(v, m.maxval, out_max)));
  }
  return 0;
}

// ---- JPEG ------------------------------------------------------------------------
//
// The whole file is parsed first: every scan's entropy-coded data is decoded
// into per-component coefficient blocks (sequential scans, interleaved or
// not, and the four kinds of progressive scan of jdphuff.c); then each block
// goes through jidctint.c's integer IDCT (after jdcoefct.c's block smoothing
// where a progressive file leaves low AC coefficients incomplete), each
// component through jdsample.c's upsampler and the pixels through jdcolor.c,
// each as libjpeg-turbo 3.1.3 computes it.

enum JpegError {
  kJpegNotJpeg = -20,
  kJpegHierarchical = -21,  // differential frames (SOF5-7, SOF13-15)
  kJpegLossless = -23,      // SOF11 (arithmetic-coded lossless)
  kJpegPrecision = -24,     // sample precision other than 8 bits
  kJpegComponents = -25,    // 2, or more than 4, components
  kJpegSampling = -26,      // a sampling ratio that is not an integer
  kJpegCorrupt = -27,
  kJpegTruncated = -28,
  kJpegNoFrame = -29,
  kJpegTooLarge = -30,      // its coefficients do not fit in memory
  kJpegProgression = -31,   // a progressive scan's Ss, Se, Ah, Al out of range
  kJpegMcuSize = -32,       // an interleaved scan of more than 10 blocks an MCU
  kJpegLosslessColor = -33, // a lossless frame that needs a colour conversion
  kJpegRestart = -34,       // a lossless restart interval not of whole MCU rows
  kJpegPixels = -35,        // past kPillowMaxPixels
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

// libjpeg's (JCOEF)LEFT_SHIFT(v, al): the shift on unsigned bits, then the
// 16-bit truncation
inline int16_t coef_shift(int64_t v, int al) {
  return (int16_t)(uint16_t)((uint64_t)v << al);
}

constexpr int kSavedCoefs = 10;  // jdcoefct.c's SAVED_COEFS

struct JpegComponent {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int64_t width, height;    // downsampled_width / _height
  int64_t bw, bh;           // blocks allocated: whole MCUs
  int64_t wblocks, hblocks;  // blocks that hold samples
  bool scanned = false;
  uint16_t quant[64] = {};   // latched at the component's first scan
  int coef_bits[64];         // jdphuff.c: -1 until a scan sends the
                             // coefficient, then that scan's Al
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order (lossless:
                              // bh * bw sample differences)
  std::vector<uint8_t> samples;  // lossless: the samples, bw a row
};

enum JpegColor { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Jpeg {
  int32_t w = 0, h = 0;
  int ncomp = 0, hmax = 1, vmax = 1;
  bool progressive = false, arithmetic = false, lossless = false;
  JpegColor color = kGray;
  uint8_t dc_L[16], dc_U[16], ac_K[16];  // DAC conditioning (jdmarker.c's get_soi
                                         // defaults: 0, 1, 5)
  Jpeg() {
    std::fill(dc_L, dc_L + 16, 0), std::fill(dc_U, dc_U + 16, 1);
    std::fill(ac_K, ac_K + 16, 5);
  }
  JpegComponent comp[4];
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int64_t mcux = 0, mcuy = 0;  // MCUs of an interleaved scan; mcuy: iMCU rows
};

int jpeg_frame(Jpeg* j, const uint8_t* seg, int n) {
  if (n < 6) return kJpegCorrupt;
  if (seg[0] != 8) return kJpegPrecision;
  j->h = be16(seg + 1);
  j->w = be16(seg + 3);
  j->ncomp = seg[5];
  if (j->w <= 0 || j->h <= 0) return kJpegCorrupt;  // DNL-defined heights too
  if ((int64_t)j->w * j->h > kPillowMaxPixels) return kJpegPixels;
  if (j->ncomp != 1 && j->ncomp != 3 && j->ncomp != 4) return kJpegComponents;
  if (n < 6 + 3 * j->ncomp) return kJpegCorrupt;
  for (int c = 0; c < j->ncomp; c++) {
    JpegComponent& k = j->comp[c];
    k.id = seg[6 + 3 * c];
    k.h = seg[7 + 3 * c] >> 4;
    k.v = seg[7 + 3 * c] & 15;
    k.tq = seg[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return kJpegCorrupt;
    for (int i = 0; i < c; i++)
      if (j->comp[i].id == k.id) return kJpegCorrupt;
    j->hmax = std::max(j->hmax, k.h);
    j->vmax = std::max(j->vmax, k.v);
    std::fill(k.coef_bits, k.coef_bits + 64, -1);
  }
  // one component: its factors mean nothing (its blocks are never
  // interleaved and it is never upsampled)
  if (j->ncomp == 1) j->comp[0].h = j->comp[0].v = j->hmax = j->vmax = 1;
  // a block is 8x8 samples, or one sample in a lossless frame
  const int64_t unit = j->lossless ? 1 : 8;
  j->mcux = (j->w + unit * j->hmax - 1) / (unit * j->hmax);
  j->mcuy = (j->h + unit * j->vmax - 1) / (unit * j->vmax);
  for (int c = 0; c < j->ncomp; c++) {
    JpegComponent& k = j->comp[c];
    // jdsample.c's jinit_upsampler takes integral ratios only
    if (j->hmax % k.h || j->vmax % k.v) return kJpegSampling;
    k.width = ((int64_t)j->w * k.h + j->hmax - 1) / j->hmax;
    k.height = ((int64_t)j->h * k.v + j->vmax - 1) / j->vmax;
    k.wblocks = (k.width + unit - 1) / unit;
    k.hblocks = (k.height + unit - 1) / unit;
    k.bw = j->mcux * k.h, k.bh = j->mcuy * k.v;
    k.coef.assign((size_t)(k.bw * k.bh * (j->lossless ? 1 : 64)), 0);
    if (j->lossless) k.samples.assign((size_t)(k.bw * k.bh), 0);
  }
  return 0;
}

// jdapimin.c's default_decompress_parms, from the markers seen before the
// first scan: three components are RGB (no conversion) under an Adobe
// marker with transform 0, or with the component ids 'R', 'G', 'B' and
// neither marker (in a lossless frame, with any ids), YCbCr otherwise;
// four are YCCK under an Adobe marker with a transform other than 0, CMYK
// otherwise.
void jpeg_colorspace(Jpeg* j) {
  if (j->ncomp == 1) {
    j->color = kGray;
  } else if (j->ncomp == 4) {
    j->color = j->adobe && j->adobe_transform != 0 ? kYCCK : kCMYK;
  } else if (j->jfif) {
    j->color = kYCbCr;
  } else if (j->adobe) {
    j->color = j->adobe_transform == 0 ? kRGB : kYCbCr;
  } else {
    // without a marker, ids 'R', 'G', 'B' are RGB, and so is any lossless
    // frame
    const bool rgb = j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66;
    j->color = rgb || j->lossless ? kRGB : kYCbCr;
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

// The state of one scan's entropy decoder (jdhuff.c, jdphuff.c).
struct Scan {
  int ss, se, ah, al;
  int64_t pred[4] = {};  // last DC value of each component in the scan
  int eobrun = 0;
};

// a DC difference added to the prediction; libjpeg refuses a sum past int
inline int dc_add(int64_t* pred, int s) {
  const int64_t v = *pred + s;
  if (v > INT32_MAX || v < INT32_MIN) return kJpegCorrupt;
  *pred = v;
  return 0;
}

// jdphuff.c's decode_mcu_DC_first, for one block
int decode_dc_first(BitReader& br, const Huffman& dc, int64_t* pred, int al, int16_t* blk) {
  int s = br.decode(dc);
  if (s < 0 || s > 15) return kJpegCorrupt;
  if (s) s = extend(br.bits(s), s);
  if (dc_add(pred, s)) return kJpegCorrupt;
  blk[0] = coef_shift(*pred, al);
  return 0;
}

// sequential (jdhuff.c's decode_mcu): one whole block (a run of zeros
// before EOB ends the block: no EOB runs here)
int decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int64_t* pred,
                 int16_t* blk) {
  if (decode_dc_first(br, dc, pred, 0, blk)) return kJpegCorrupt;
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

// decode_mcu_AC_first
int decode_ac_first(BitReader& br, const Huffman& ac, Scan& sc, int16_t* blk) {
  if (sc.eobrun > 0) {  // a band of zeros
    sc.eobrun--;
    return 0;
  }
  for (int k = sc.ss; k <= sc.se; k++) {
    const int rs = br.decode(ac);
    if (rs < 0) return kJpegCorrupt;
    const int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = coef_shift(extend(br.bits(s), s), sc.al);
    } else if (r == 15) {  // ZRL
      k += 15;
    } else {  // EOBr: a run of 2^r + r more bits blocks, this one included
      sc.eobrun = 1 << r;
      if (r) sc.eobrun += br.bits(r);
      sc.eobrun--;
      break;
    }
  }
  return 0;
}

// decode_mcu_AC_refine: one correction bit for every coefficient already
// nonzero in the band, and the newly nonzero ones at +-2^Al
int decode_ac_refine(BitReader& br, const Huffman& ac, Scan& sc, int16_t* blk) {
  const int p1 = 1 << sc.al, m1 = -p1;
  auto correct = [&](int16_t* c) {
    if (br.bits(1) && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
  };
  int k = sc.ss;
  if (sc.eobrun == 0) {
    for (; k <= sc.se; k++) {
      const int rs = br.decode(ac);
      if (rs < 0) return kJpegCorrupt;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.bits(1) ? p1 : m1;  // a size other than 1 is only warned of
      } else if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.bits(r);
        break;  // the rest of the block is the EOB run's
      }
      // skip r zeros (and correct the nonzeros passed on the way)
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; k++)
      if (blk[kNatural[k]] != 0) correct(blk + kNatural[k]);
    sc.eobrun--;
  }
  return 0;
}

// ---- JPEG arithmetic coding (jdarith.c) -------------------------------------------

// jaricom.c's jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS (Table D.2, and a last state of fixed probability 0.5)
constexpr uint32_t qm(uint32_t qe, uint32_t nlps, uint32_t nmps, uint32_t sw) {
  return qe << 16 | nmps << 8 | sw << 7 | nlps;
}
constexpr uint32_t kAritab[114] = {
    qm(0x5a1d, 1, 1, 1),     qm(0x2586, 14, 2, 0),    qm(0x1114, 16, 3, 0),
    qm(0x080b, 18, 4, 0),    qm(0x03d8, 20, 5, 0),    qm(0x01da, 23, 6, 0),
    qm(0x00e5, 25, 7, 0),    qm(0x006f, 28, 8, 0),    qm(0x0036, 30, 9, 0),
    qm(0x001a, 33, 10, 0),   qm(0x000d, 35, 11, 0),   qm(0x0006, 9, 12, 0),
    qm(0x0003, 10, 13, 0),   qm(0x0001, 12, 13, 0),   qm(0x5a7f, 15, 15, 1),
    qm(0x3f25, 36, 16, 0),   qm(0x2cf2, 38, 17, 0),   qm(0x207c, 39, 18, 0),
    qm(0x17b9, 40, 19, 0),   qm(0x1182, 42, 20, 0),   qm(0x0cef, 43, 21, 0),
    qm(0x09a1, 45, 22, 0),   qm(0x072f, 46, 23, 0),   qm(0x055c, 48, 24, 0),
    qm(0x0406, 49, 25, 0),   qm(0x0303, 51, 26, 0),   qm(0x0240, 52, 27, 0),
    qm(0x01b1, 54, 28, 0),   qm(0x0144, 56, 29, 0),   qm(0x00f5, 57, 30, 0),
    qm(0x00b7, 59, 31, 0),   qm(0x008a, 60, 32, 0),   qm(0x0068, 62, 33, 0),
    qm(0x004e, 63, 34, 0),   qm(0x003b, 32, 35, 0),   qm(0x002c, 33, 9, 0),
    qm(0x5ae1, 37, 37, 1),   qm(0x484c, 64, 38, 0),   qm(0x3a0d, 65, 39, 0),
    qm(0x2ef1, 67, 40, 0),   qm(0x261f, 68, 41, 0),   qm(0x1f33, 69, 42, 0),
    qm(0x19a8, 70, 43, 0),   qm(0x1518, 72, 44, 0),   qm(0x1177, 73, 45, 0),
    qm(0x0e74, 74, 46, 0),   qm(0x0bfb, 75, 47, 0),   qm(0x09f8, 77, 48, 0),
    qm(0x0861, 78, 49, 0),   qm(0x0706, 79, 50, 0),   qm(0x05cd, 48, 51, 0),
    qm(0x04de, 50, 52, 0),   qm(0x040f, 50, 53, 0),   qm(0x0363, 51, 54, 0),
    qm(0x02d4, 52, 55, 0),   qm(0x025c, 53, 56, 0),   qm(0x01f8, 54, 57, 0),
    qm(0x01a4, 55, 58, 0),   qm(0x0160, 56, 59, 0),   qm(0x0125, 57, 60, 0),
    qm(0x00f6, 58, 61, 0),   qm(0x00cb, 59, 62, 0),   qm(0x00ab, 61, 63, 0),
    qm(0x008f, 61, 32, 0),   qm(0x5b12, 65, 65, 1),   qm(0x4d04, 80, 66, 0),
    qm(0x412c, 81, 67, 0),   qm(0x37d8, 82, 68, 0),   qm(0x2fe8, 83, 69, 0),
    qm(0x293c, 84, 70, 0),   qm(0x2379, 86, 71, 0),   qm(0x1edf, 87, 72, 0),
    qm(0x1aa9, 87, 73, 0),   qm(0x174e, 72, 74, 0),   qm(0x1424, 72, 75, 0),
    qm(0x119c, 74, 76, 0),   qm(0x0f6b, 74, 77, 0),   qm(0x0d51, 75, 78, 0),
    qm(0x0bb6, 77, 79, 0),   qm(0x0a40, 77, 48, 0),   qm(0x5832, 80, 81, 1),
    qm(0x4d1c, 88, 82, 0),   qm(0x438e, 89, 83, 0),   qm(0x3bdd, 90, 84, 0),
    qm(0x34ee, 91, 85, 0),   qm(0x2eae, 92, 86, 0),   qm(0x299a, 93, 87, 0),
    qm(0x2516, 86, 71, 0),   qm(0x5570, 88, 89, 1),   qm(0x4ca9, 95, 90, 0),
    qm(0x44d9, 96, 91, 0),   qm(0x3e22, 97, 92, 0),   qm(0x3824, 99, 93, 0),
    qm(0x32b4, 99, 94, 0),   qm(0x2e17, 93, 86, 0),   qm(0x56a8, 95, 96, 1),
    qm(0x4f46, 101, 97, 0),  qm(0x47e5, 102, 98, 0),  qm(0x41cf, 103, 99, 0),
    qm(0x3c3d, 104, 100, 0), qm(0x375e, 99, 93, 0),   qm(0x5231, 105, 102, 0),
    qm(0x4c0f, 106, 103, 0), qm(0x4639, 107, 104, 0), qm(0x415e, 103, 99, 0),
    qm(0x5627, 105, 106, 1), qm(0x50e7, 108, 107, 0), qm(0x4b85, 109, 103, 0),
    qm(0x5597, 110, 109, 0), qm(0x504f, 111, 107, 0), qm(0x5a10, 110, 111, 1),
    qm(0x5522, 112, 109, 0), qm(0x59eb, 112, 111, 1), qm(0x5a1d, 113, 113, 0)};

// The QM decoder of one scan (arith_decode): statistics bins of one byte,
// the MPS in the top bit and the state in the low seven.
struct ArithDecoder {
  const uint8_t* buf;
  int64_t len, pos;
  bool marker = false;  // a marker was reached: zeros from here on
  int64_t c = 0, a = 0;
  int ct = -16;  // two bytes to fetch first

  void reset() { c = 0, a = 0, ct = -16; }
  int byte() {
    if (marker || pos >= len) return 0;
    int d = buf[pos];
    if (d != 0xFF) {
      pos++;
      return d;
    }
    int64_t q = pos + 1;
    while (q < len && buf[q] == 0xFF) q++;  // fill bytes
    if (q < len && buf[q] == 0) {
      pos = q + 1;
      return 0xFF;  // a stuffed zero
    }
    marker = true;  // stay on the marker
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two first bytes in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct ArithStats {
  uint8_t dc[16][64], ac[16][256];
  uint8_t fixed[4] = {113, 0, 0, 0};  // probability 0.5
};

// The AC magnitude: its first category bin is st, its X2.. bins 189 or 217
// by Kx.
int arith_ac_magnitude(ArithDecoder& d, uint8_t* st, uint8_t* ac, int k, int kx, int* out) {
  int m = d.decode(st);
  if (m && d.decode(st)) {
    m <<= 1;
    st = ac + (k <= kx ? 189 : 217);
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return -1;
      st += 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  *out = v + 1;
  return 0;
}

constexpr int kArithStop = 1;  // libjpeg's ct = -1: the rest of the scan is skipped

struct ArithScan {
  int dc_context[4] = {};
  int last_dc[4] = {};
};

// Figure F.19 (Decode_DC_DIFF) and the conditioning of F.1.4.4.1.2.
int arith_dc(ArithDecoder& d, ArithStats& s, ArithScan& as, int i, int tbl, int L, int U) {
  uint8_t* st = s.dc[tbl] + as.dc_context[i];
  if (d.decode(st) == 0) {
    as.dc_context[i] = 0;
    return 0;
  }
  const int sign = d.decode(st + 1);
  st += 2 + sign;
  int m = d.decode(st);
  if (m) {
    st = s.dc[tbl] + 20;
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return kArithStop;
      st += 1;
    }
  }
  if (m < (int)((1L << L) >> 1))
    as.dc_context[i] = 0;
  else if (m > (int)((1L << U) >> 1))
    as.dc_context[i] = 12 + sign * 4;
  else
    as.dc_context[i] = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  as.last_dc[i] = (as.last_dc[i] + v) & 0xFFFF;
  return 0;
}

// decode_mcu_AC_first
int arith_ac_first(ArithDecoder& d, ArithStats& s, int tbl, int kx, int ss, int se, int al,
                   int16_t* blk) {
  uint8_t* ac = s.ac[tbl];
  for (int k = ss; k <= se; k++) {
    uint8_t* st = ac + 3 * (k - 1);
    if (d.decode(st)) break;  // EOB
    while (d.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) return kArithStop;
    }
    const int sign = d.decode(s.fixed);
    int v;
    if (arith_ac_magnitude(d, st + 2, ac, k, kx, &v)) return kArithStop;
    blk[kNatural[k]] = coef_shift(sign ? -v : v, al);
  }
  return 0;
}

// decode_mcu_AC_refine: a correction bit for every coefficient already
// nonzero, a sign for each newly nonzero one
int arith_ac_refine(ArithDecoder& d, ArithStats& s, int tbl, int ss, int se, int al,
                    int16_t* blk) {
  uint8_t* ac = s.ac[tbl];
  const int p1 = 1 << al, m1 = -p1;
  int kex = se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = ac + 3 * (k - 1);
    if (k > kex && d.decode(st)) break;  // EOB
    while (true) {
      int16_t* c = blk + kNatural[k];
      if (*c) {
        if (d.decode(st + 2)) *c = (int16_t)(*c + (*c < 0 ? m1 : p1));
        break;
      }
      if (d.decode(st + 1)) {
        *c = (int16_t)(d.decode(s.fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return kArithStop;
    }
  }
  return 0;
}

// jdlossls.c / jddiffct.c: one lossless component's sample differences
// (coef, bw a row) turned into samples. A row's first sample is predicted
// from the one above, the others by predictor ps (1-7) from the left (a),
// upper (b) and upper-left (c) samples, mod 2^16; the first row of the
// scan, and the first row of each iMCU row in which a restart interval
// began, from the left only, its first sample from 2^(7 - pt). Then << pt,
// kept to 8 bits.
void lossless_undifference(JpegComponent& k, int ps, int pt, const std::vector<bool>& reset) {
  const int64_t w = k.width, h = k.height, v = k.v;
  std::vector<int> prev((size_t)w), cur((size_t)w);
  for (int64_t r = 0; r < h; r++) {
    const int16_t* d = k.coef.data() + r * k.bw;
    const bool first = r % v == 0 && reset[(size_t)(r / v)];
    for (int64_t x = 0; x < w; x++) {
      int pred;
      if (first) {
        pred = x == 0 ? 1 << (7 - pt) : cur[x - 1];
      } else if (x == 0) {
        pred = prev[0];
      } else {
        const int a = cur[x - 1], b = prev[x], c = prev[x - 1];
        switch (ps) {
          case 1: pred = a; break;
          case 2: pred = b; break;
          case 3: pred = c; break;
          case 4: pred = a + b - c; break;
          case 5: pred = a + ((b - c) >> 1); break;
          case 6: pred = b + ((a - c) >> 1); break;
          default: pred = (a + b) >> 1; break;
        }
      }
      cur[x] = (d[x] + pred) & 0xFFFF;
      k.samples[(size_t)(r * k.bw + x)] = (uint8_t)(cur[x] << pt);
    }
    std::swap(prev, cur);
  }
}

// One scan from its SOS header (seg, n bytes); *pos: the entropy-coded data,
// left at the first byte after it.
int jpeg_scan(Jpeg* j, const uint8_t* seg, int n, const uint8_t* buf, int64_t len,
              int64_t* pos) {
  if (j->ncomp == 0) return kJpegNoFrame;
  if (n < 1) return kJpegCorrupt;
  const int ns = seg[0];
  if (ns < 1 || ns > j->ncomp || n < 1 + 2 * ns + 3) return kJpegCorrupt;
  const int ntables = j->arithmetic ? 16 : 4;
  JpegComponent* sc[4];
  for (int i = 0; i < ns; i++) {
    const int id = seg[1 + 2 * i];
    sc[i] = nullptr;
    for (int c = 0; c < j->ncomp; c++)
      if (j->comp[c].id == id) sc[i] = &j->comp[c];
    if (!sc[i]) return kJpegCorrupt;
    for (int q = 0; q < i; q++)
      if (sc[q] == sc[i]) return kJpegCorrupt;
    sc[i]->dc_tbl = seg[2 + 2 * i] >> 4;
    sc[i]->ac_tbl = seg[2 + 2 * i] & 15;
    if (sc[i]->dc_tbl >= ntables || sc[i]->ac_tbl >= ntables) return kJpegCorrupt;
  }
  Scan st;
  st.ss = seg[1 + 2 * ns];
  st.se = seg[2 + 2 * ns];
  st.ah = seg[3 + 2 * ns] >> 4;
  st.al = seg[3 + 2 * ns] & 15;
  const bool dc_band = st.ss == 0;
  if (j->lossless && (st.ss < 1 || st.ss > 7 || st.se || st.ah || st.al > 7))
    return kJpegProgression;  // Ss: the predictor, Al: the point transform
  // a sequential scan's Ss, Se, Ah, Al other than 0, 63, 0, 0 are only
  // warned of (JWRN_NOT_SEQUENTIAL): the scan is decoded whole all the same
  if (j->progressive) {
    // jdphuff.c's start_pass_phuff_decoder, jdarith.c's start_pass
    bool bad = dc_band ? st.se != 0 : (st.ss > st.se || st.se > 63 || ns != 1);
    if (st.ah && st.al != st.ah - 1) bad = true;
    if (st.al > 13) bad = true;
    if (bad) return kJpegProgression;
  }
  // which statistics a scan codes with: DC unless it refines DC, AC unless
  // it is a progressive DC scan
  const bool codes_dc = !j->progressive || (dc_band && st.ah == 0);
  const bool codes_ac = !j->lossless && (!j->progressive || !dc_band);
  for (int i = 0; i < ns; i++) {
    if (!j->arithmetic && ((codes_dc && !j->dc[sc[i]->dc_tbl].defined) ||
                           (codes_ac && !j->ac[sc[i]->ac_tbl].defined)))
      return kJpegCorrupt;
    if (!sc[i]->scanned) {  // a lossless frame needs no quantizers
      if (!j->lossless && !j->quant_defined[sc[i]->tq]) return kJpegCorrupt;
      std::memcpy(sc[i]->quant, j->quant[sc[i]->tq], sizeof(sc[i]->quant));
      sc[i]->scanned = true;
    }
    if (j->progressive)
      for (int k = st.ss; k <= st.se; k++) sc[i]->coef_bits[k] = st.al;
  }
  // MCUs: one block of the component when it is alone in the scan
  int64_t mcux = j->mcux, mcuy = j->mcuy;
  if (ns == 1) {
    mcux = sc[0]->wblocks, mcuy = sc[0]->hblocks;
  } else {
    int blocks = 0;
    for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
    if (blocks > 10) return kJpegMcuSize;  // jdinput.c's D_MAX_BLOCKS_IN_MCU
  }
  // lossless: restarts come at whole MCU rows (jddiffct.c), and each resets
  // the predictor for its iMCU row
  std::vector<bool> reset;
  if (j->lossless) {
    if (j->restart % mcux) return kJpegRestart;
    reset.assign((size_t)(ns == 1 ? (mcuy + sc[0]->v - 1) / sc[0]->v : mcuy), false);
    reset[0] = true;
  }
  BitReader br{buf, len, *pos};
  ArithDecoder ad{buf, len, *pos};
  static thread_local ArithStats stats;
  ArithScan as;
  // the statistics of the tables in use start at zero, in each restart
  // interval too
  auto reset_stats = [&]() {
    for (int i = 0; i < ns; i++) {
      if (codes_dc) std::memset(stats.dc[sc[i]->dc_tbl], 0, 64);
      if (codes_ac) std::memset(stats.ac[sc[i]->ac_tbl], 0, 256);
      as.dc_context[i] = as.last_dc[i] = 0;
    }
  };
  if (j->arithmetic) reset_stats();
  int64_t& p = j->arithmetic ? ad.pos : br.pos;
  bool stopped = false;  // an arithmetic-coded scan libjpeg gives up on
  int64_t left = j->restart;
  const int64_t total = mcux * mcuy;
  int next_rst = 0;
  for (int64_t m = 0; m < total; m++) {
    if (j->restart && left == 0) {
      // process_restart: drop the buffered bits, pass RSTn, reset the DC
      // predictions and the EOB run (the statistics, for arithmetic coding)
      int64_t q = p;
      while (q < len && buf[q] != 0xFF) q++;  // skip what a short segment left
      while (q + 1 < len && buf[q] == 0xFF && buf[q + 1] == 0xFF) q++;
      if (q + 1 >= len) return kJpegTruncated;
      if (buf[q + 1] != 0xD0 + next_rst) return kJpegCorrupt;
      p = q + 2;
      next_rst = (next_rst + 1) & 7;
      st.pred[0] = st.pred[1] = st.pred[2] = st.pred[3] = 0;
      st.eobrun = 0;
      left = j->restart;
      br.reset();
      ad.reset(), ad.marker = false;
      if (j->arithmetic) reset_stats();
      stopped = false;
      if (j->lossless) reset[(size_t)(ns == 1 ? m / mcux / sc[0]->v : m / mcux)] = true;
    }
    const int64_t mx = m % mcux, my = m / mcux;
    for (int i = 0; i < ns && !stopped; i++) {
      JpegComponent& k = *sc[i];
      const int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
      for (int by = 0; by < bh && !stopped; by++) {
        for (int bx = 0; bx < bwid && !stopped; bx++) {
          const int64_t row = my * bh + by, col = mx * bwid + bx;
          if (j->lossless) {  // jdlhuff.c: one sample difference
            int s = br.decode(j->dc[k.dc_tbl]);
            if (s < 0 || s > 16) return kJpegCorrupt;
            s = s == 16 ? 32768 : s ? extend(br.bits(s), s) : 0;
            k.coef[(size_t)(row * k.bw + col)] = (int16_t)(uint16_t)s;
            continue;
          }
          int16_t* blk = k.coef.data() + (row * k.bw + col) * 64;
          int rc = 0;
          if (j->arithmetic) {
            if (!j->progressive) {  // jdarith.c's decode_mcu: DC, then AC 1-63
              rc = arith_dc(ad, stats, as, i, k.dc_tbl, j->dc_L[k.dc_tbl], j->dc_U[k.dc_tbl]);
              if (!rc) {
                blk[0] = (int16_t)as.last_dc[i];
                rc = arith_ac_first(ad, stats, k.ac_tbl, j->ac_K[k.ac_tbl], 1, 63, 0, blk);
              }
            } else if (dc_band && st.ah == 0) {
              rc = arith_dc(ad, stats, as, i, k.dc_tbl, j->dc_L[k.dc_tbl], j->dc_U[k.dc_tbl]);
              if (!rc) blk[0] = coef_shift(as.last_dc[i], st.al);
            } else if (dc_band) {
              if (ad.decode(stats.fixed)) blk[0] = (int16_t)(blk[0] | (1 << st.al));
            } else if (st.ah == 0) {
              rc = arith_ac_first(ad, stats, k.ac_tbl, j->ac_K[k.ac_tbl], st.ss, st.se,
                                  st.al, blk);
            } else {
              rc = arith_ac_refine(ad, stats, k.ac_tbl, st.ss, st.se, st.al, blk);
            }
            if (rc == kArithStop) stopped = true, rc = 0;
          } else if (!j->progressive) {
            rc = decode_block(br, j->dc[k.dc_tbl], j->ac[k.ac_tbl], &st.pred[i], blk);
          } else if (dc_band && st.ah == 0) {
            rc = decode_dc_first(br, j->dc[k.dc_tbl], &st.pred[i], st.al, blk);
          } else if (dc_band) {
            if (br.bits(1)) blk[0] = (int16_t)(blk[0] | (1 << st.al));
          } else if (st.ah == 0) {
            rc = decode_ac_first(br, j->ac[k.ac_tbl], st, blk);
          } else {
            rc = decode_ac_refine(br, j->ac[k.ac_tbl], st, blk);
          }
          if (rc) return rc;
        }
      }
    }
    if (j->restart) left--;
  }
  if (j->lossless)
    for (int i = 0; i < ns; i++) lossless_undifference(*sc[i], st.ss, st.al, reset);
  // the scan's end: the next marker (bytes the last MCU did not need are
  // padding)
  int64_t q = p;
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

// jdcoefct.c's smoothing_ok: a progressive file whose every component has
// some DC bits, nonzero quantizers for the DC and the first nine AC
// coefficients, and, in some component, one of those nine not sent to full
// precision.
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  static constexpr int kPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int c = 0; c < j.ncomp; c++) {
    const JpegComponent& k = j.comp[c];
    if (!k.scanned) return false;
    for (int p : kPos)
      if (k.quant[p] == 0) return false;
    if (k.coef_bits[0] < 0) return false;
    for (int i = 1; i < kSavedCoefs; i++)
      if (k.coef_bits[i] != 0) useful = true;
  }
  return useful;
}

// An estimated coefficient (decompress_smooth_data): num / (q * 256),
// rounded, its magnitude held below 2^Al when Al > 0.
inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return (int16_t)(num >= 0 ? pred : -pred);
}

// jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later) for one
// block: the coefficients among the first nine AC ones that are still zero
// and not known to full precision are estimated from the DC values of the
// 5x5 blocks around it (d[r][c], the block at d[2][2]); the DC itself too
// when no AC coefficient has been sent at all.
void smooth_block(const int16_t* blk, const JpegComponent& k, const int d[5][5],
                  int16_t* ws) {
  std::memcpy(ws, blk, 64 * sizeof(int16_t));
  const int* bits = k.coef_bits;
  const uint16_t* q = k.quant;
  const int64_t q00 = q[0];
  bool change_dc = true;
  for (int i = 1; i < kSavedCoefs; i++)
    if (bits[i] != -1) change_dc = false;
  // DC01..DC25 of libjpeg, row by row
  const int64_t D01 = d[0][0], D02 = d[0][1], D03 = d[0][2], D04 = d[0][3], D05 = d[0][4],
                D06 = d[1][0], D07 = d[1][1], D08 = d[1][2], D09 = d[1][3], D10 = d[1][4],
                D11 = d[2][0], D12 = d[2][1], D13 = d[2][2], D14 = d[2][3], D15 = d[2][4],
                D16 = d[3][0], D17 = d[3][1], D18 = d[3][2], D19 = d[3][3], D20 = d[3][4],
                D21 = d[4][0], D22 = d[4][1], D23 = d[4][2], D24 = d[4][3], D25 = d[4][4];
  auto est = [&](int bit_index, int pos, int64_t sum) {
    const int al = bits[bit_index];
    if (al != 0 && ws[pos] == 0) ws[pos] = smooth_pred(q00 * sum, q[pos], al);
  };
  if (change_dc) {
    est(1, 1, -D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 - 13 * D09 + 3 * D10 -
                  3 * D11 + 38 * D12 - 38 * D14 + 3 * D15 - 3 * D16 + 13 * D17 -
                  13 * D19 + 3 * D20 - D21 - D22 + D24 + D25);
    est(2, 8, -D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 + 13 * D07 + 38 * D08 +
                  13 * D09 - D10 + D16 - 13 * D17 - 38 * D18 - 13 * D19 + D20 + D21 +
                  3 * D22 + 3 * D23 + 3 * D24 + D25);
    est(3, 16, D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 - 14 * D13 - 5 * D14 +
                   2 * D17 + 7 * D18 + 2 * D19 + D23);
    est(4, 9, -D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25);
    est(5, 2, 2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 - 14 * D13 + 7 * D14 + D15 +
                  2 * D17 - 5 * D18 + 2 * D19);
    est(6, 3, D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19);
    est(7, 10, D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19);
    est(8, 17, D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19);
    est(9, 24, D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19);
    const int64_t num =
        q00 * (-2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05 - 6 * D06 + 6 * D07 +
               42 * D08 + 6 * D09 - 6 * D10 - 8 * D11 + 42 * D12 + 152 * D13 +
               42 * D14 - 8 * D15 - 6 * D16 + 6 * D17 + 42 * D18 + 6 * D19 - 6 * D20 -
               2 * D21 - 6 * D22 - 8 * D23 - 6 * D24 - 2 * D25);
    ws[0] = smooth_pred(num, q00, 0);
  } else {
    est(1, 1, -7 * D11 + 50 * D12 - 50 * D14 + 7 * D15);
    est(2, 8, -7 * D03 + 50 * D08 - 50 * D18 + 7 * D23);
    est(3, 16, -D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23);
    est(4, 9, D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 + D04 - D06 +
                  10 * D07 - 10 * D09);
    est(5, 2, -D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15);
  }
}

// A component's samples, [hblocks * 8, bw * 8] (row stride bw * 8); imcu_rows:
// the frame's iMCU rows (hblocks for a single component).
std::vector<uint8_t> component_plane(const JpegComponent& k, bool smooth, int64_t imcu_rows) {
  const int64_t stride = k.bw * 8;
  std::vector<uint8_t> plane((size_t)(stride * k.hblocks * 8));
  if (!smooth) {
    for (int64_t by = 0; by < k.hblocks; by++)
      for (int64_t bx = 0; bx < k.wblocks; bx++)
        idct_islow(k.coef.data() + (by * k.bw + bx) * 64, k.quant,
                   plane.data() + by * 8 * stride + bx * 8, stride);
    return plane;
  }
  // The neighbouring block rows as decompress_smooth_data picks them: its
  // row index counts the last iMCU row's block rows as if every iMCU row
  // had that many, so near the bottom it may repeat a row, or read a row
  // of dummy blocks, where a plain index would not.
  const int64_t T = imcu_rows, v = k.v;
  const int64_t last_rows = k.hblocks % v ? k.hblocks % v : v;
  int16_t ws[64];
  for (int64_t r = 0; r < k.hblocks; r++) {
    int64_t idx = r, rows = v * T;
    if (r / v >= T - 1) idx = (T - 1) * last_rows + (r - (T - 1) * v), rows = last_rows * T;
    const int64_t prev = idx > 0 ? r - 1 : r, pprev = idx > 1 ? r - 2 : prev;
    const int64_t next = idx < rows - 1 ? r + 1 : r, nnext = idx < rows - 2 ? r + 2 : next;
    const int64_t src[5] = {pprev, prev, r, next, nnext};
    const int64_t last = k.wblocks - 1;
    for (int64_t b = 0; b <= last; b++) {
      // the 5x5 DC values, columns past either edge replaced by the edge's
      int d[5][5];
      for (int i = 0; i < 5; i++)
        for (int c = 0; c < 5; c++) {
          const int64_t col = std::min(std::max<int64_t>(b + c - 2, 0), last);
          d[i][c] = k.coef[(src[i] * k.bw + col) * 64];
        }
      smooth_block(k.coef.data() + (r * k.bw + b) * 64, k, d, ws);
      idct_islow(ws, k.quant, plane.data() + r * 8 * stride + b * 8, stride);
    }
  }
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

// h1v2_fancy_upsample: output row 2r + v = (3 * row r + row r -+ 1 + 1 or 2)
// / 4, the edge rows duplicated.
void h1v2_row(const uint8_t* in0, const uint8_t* in1, int bias, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)((in0[i] * 3 + in1[i] + bias) >> 2);
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
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        if (j->ncomp) return kJpegCorrupt;  // a second frame
        j->progressive = marker == 0xC2 || marker == 0xCA;
        j->arithmetic = marker >= 0xC9;
        j->lossless = marker == 0xC3;
        rc = jpeg_frame(j, seg, n);
        if (!rc && headers_only) return 0;
        break;
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        return kJpegHierarchical;
      case 0xCC:  // DAC (get_dac)
        if (n % 2) return kJpegCorrupt;
        for (int q = 0; q < n; q += 2) {
          const int index = seg[q], val = seg[q + 1];
          if (index >= 32) return kJpegCorrupt;
          if (index >= 16) {
            j->ac_K[index - 16] = (uint8_t)val;
          } else {
            j->dc_L[index] = val & 15, j->dc_U[index] = val >> 4;
            if (j->dc_L[index] > j->dc_U[index]) return kJpegCorrupt;
          }
        }
        break;
      case 0xCB: return kJpegLossless;
      case 0xC4: rc = jpeg_dht(j, seg, n); break;
      case 0xDB: rc = jpeg_dqt(j, seg, n); break;
      case 0xDD:
        if (n < 2) return kJpegCorrupt;
        j->restart = be16(seg);
        break;
      case 0xDA:
        if (!scans++) {
          jpeg_colorspace(j);
          // jdcolor.c converts no colour space in a lossless frame
          if (j->lossless && (j->color == kYCbCr || j->color == kYCCK))
            return kJpegLosslessColor;
        }
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
      default: break;  // APPn, COM, DNL, DHP, EXP...: skipped
    }
    if (rc) return rc;
  }
  if (!j->ncomp) return kJpegNoFrame;
  if (headers_only) return 0;
  for (int c = 0; c < j->ncomp; c++)
    if (!j->comp[c].scanned) return kJpegCorrupt;
  return 0;
}

// The channels of the decoded image: 1 (gray) or 3 (RGB; for four
// components, the first three of Pillow's inverted CMYK).
inline int jpeg_channels(const Jpeg& j) { return j.ncomp == 1 ? 1 : 3; }

// The decoded image: out holds h*w*jpeg_channels uint8.
int jpeg_output(const Jpeg& j, uint8_t* out) {
  const int64_t w = j.w, h = j.h;
  const bool smooth = smoothing_ok(j);
  // a component's samples: the IDCT's (8 a block), or a lossless frame's
  auto plane_of = [&](const JpegComponent& k, int64_t imcu_rows) {
    return j.lossless ? k.samples : component_plane(k, smooth, imcu_rows);
  };
  const int64_t unit = j.lossless ? 1 : 8;
  if (j.ncomp == 1) {
    const JpegComponent& k = j.comp[0];
    std::vector<uint8_t> plane = plane_of(k, k.hblocks);
    for (int64_t y = 0; y < h; y++)
      std::memcpy(out + y * w, plane.data() + y * k.bw * unit, (size_t)w);
    return 0;
  }
  static const YccTables t;
  const int nc = std::min(j.ncomp, 3);  // the fourth (K) is dropped
  std::vector<uint8_t> planes[3];
  std::vector<uint8_t> rows[3];
  for (int c = 0; c < nc; c++) {
    planes[c] = plane_of(j.comp[c], j.mcuy);
    rows[c].resize((size_t)(w + 16));
  }
  // jinit_upsampler: no fancy upsampling where a block is one sample
  const bool fancy = !j.lossless;
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* px[3];
    for (int c = 0; c < nc; c++) {
      // jinit_upsampler's choice for this component
      const JpegComponent& k = j.comp[c];
      const int64_t stride = k.bw * unit;
      const uint8_t* p = planes[c].data();
      const int rh = j.hmax / k.h, rv = j.vmax / k.v;
      uint8_t* o = rows[c].data();
      px[c] = o;
      if (rh == 1 && rv == 1) {
        px[c] = p + y * stride;
      } else if (fancy && rh == 2 && rv == 1) {
        h2v1_row(p + y * stride, k.width, o);
      } else if (fancy && rh == 1 && rv == 2) {
        const int64_t r = y / 2;
        const int64_t other = (y & 1) ? std::min(r + 1, k.height - 1) : std::max<int64_t>(r - 1, 0);
        h1v2_row(p + r * stride, p + other * stride, (y & 1) ? 2 : 1, k.width, o);
      } else if (fancy && rh == 2 && rv == 2) {
        const int64_t r = y / 2;
        const int64_t other = (y & 1) ? std::min(r + 1, k.height - 1) : std::max<int64_t>(r - 1, 0);
        h2v2_row(p + r * stride, p + other * stride, k.width, o);
      } else {  // int_upsample: each sample repeated rh x rv times
        const uint8_t* in = p + (y / rv) * stride;
        for (int64_t x = 0; x < w; x++) o[x] = in[x / rh];
      }
    }
    uint8_t* o = out + y * w * 3;
    if (j.color == kRGB) {
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = px[0][x], o[3 * x + 1] = px[1][x], o[3 * x + 2] = px[2][x];
      }
    } else if (j.color == kCMYK) {  // Pillow's "CMYK;I": every sample inverted
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = (uint8_t)(255 - px[0][x]), o[3 * x + 1] = (uint8_t)(255 - px[1][x]);
        o[3 * x + 2] = (uint8_t)(255 - px[2][x]);
      }
    } else {
      // YCbCr -> RGB; YCCK -> CMYK (ycck_cmyk_convert: 255 - the same RGB),
      // inverted back by Pillow's "CMYK;I", is the same three values
      for (int64_t x = 0; x < w; x++) {
        const int yy = px[0][x], cb = px[1][x], cr = px[2][x];
        o[3 * x] = clamp255(yy + t.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
      }
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

// Any PNM the way Pillow reads it (see PNM as Pillow reads it): the size,
// channels (1 or 3) and element type (PnmType).
int pnm_probe(const uint8_t* buf, int64_t len, int32_t* w, int32_t* h,
              int32_t* channels, int32_t* type) {
  Pnm m;
  int rc = pnm_header(buf, len, &m);
  if (rc) return rc;
  *w = (int32_t)m.w;
  *h = (int32_t)m.h;
  *channels = m.channels;
  *type = m.type;
  return 0;
}

// The whole image: out holds h*w*channels elements of the probed type.
int pnm_decode(const uint8_t* buf, int64_t len, void* out) {
  try {  // no exception may cross the C boundary
    Pnm m;
    int rc = pnm_header(buf, len, &m);
    if (rc) return rc;
    if (m.kind == '1') return pnm_plain_bits(buf, len, m, static_cast<uint8_t*>(out));
    if (m.kind == '2' || m.kind == '3') return pnm_plain_values(buf, len, m, out);
    return pnm_binary(buf, len, m, out);
  } catch (const std::bad_alloc&) {
    return kPnmTruncated;
  }
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
  *channels = jpeg_channels(j);
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
