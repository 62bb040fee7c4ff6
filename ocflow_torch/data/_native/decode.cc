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
//         16-bit samples in host order. Interlaced (Adam7) images are
//         refused.
//
// Every function returns 0 on success and a negative code otherwise; probes
// report the dimensions, so Python allocates the numpy output and the decode
// writes straight into it.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
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
  int32_t w, h, depth, color;
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

int64_t png_row_bytes(const Png& p) {
  return ((int64_t)p.w * png_samples(p.color) * p.depth + 7) / 8;
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

// One unfiltered row -> normalized pixels (uint8 or host-order uint16).
void normalize_row(const Png& p, const uint8_t* row, uint8_t* out8,
                   uint16_t* out16) {
  const int ch = png_channels(p);
  const int64_t w = p.w;
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
  const int64_t n = png_row_bytes(p);
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
    normalize_row(p, cur.data(), out8.data(), out16.data());
    emit(y, out8.data(), out16.data());
    std::swap(prior, cur);
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
  Png p{w, h, depth, color, nullptr, nplte, nullptr, ntrns};
  int rc = png_valid(p);
  return rc ? rc : png_channels(p);
}

// The whole image: out holds h*w*channels uint8 (depth <= 8) or uint16
// (depth 16) elements.
int png_unfilter(const uint8_t* z, int64_t zlen, int32_t w, int32_t h,
                 int32_t depth, int32_t color, const uint8_t* plte,
                 int32_t nplte, const uint8_t* trns, int32_t ntrns,
                 void* out) {
  Png p{w, h, depth, color, plte, nplte, trns, ntrns};
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
// path), -11 if the crop exceeds the image. Rows below the crop are never
// unfiltered.

int png_decode_norm_f32(const uint8_t* z, int64_t zlen, int32_t w, int32_t h,
                        int32_t depth, int32_t color, const uint8_t* plte,
                        int32_t nplte, const uint8_t* trns, int32_t ntrns,
                        float* dst, int64_t pix_stride, int32_t th,
                        int32_t tw, float scale, float offset) {
  Png p{w, h, depth, color, plte, nplte, trns, ntrns};
  int rc = png_valid(p);
  if (rc) return rc;
  const int ch = png_channels(p);
  if (depth == 16 || ch < 3) return -10;
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

}  // extern "C"
