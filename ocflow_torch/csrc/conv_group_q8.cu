// One W8A8 3x3 convolution of a conv group, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocflow_tpu/ops/pallas/conv_chain_kernel.py
// `conv_group_q8` (body `_q8_kernel_body`): a chain of 3x3 convs over an
// int8 channel stripe, int8 x int8 -> int32 GEMMs whose per-read activation
// scales are folded into per-output-channel weight scales, and a requantizing
// epilogue. The Python wrapper (kernels/conv_chain_q8.py) launches this
// kernel once per conv that reads int8 blocks; a conv reads up to MAXSEG
// int8 channel segments (group inputs or stripe block ranges, as in
// conv_group.cu), so the DenseNet concat is never materialized.
//
// Implicit GEMM on the int8 tensor cores (WMMA 16x16x16 s8 -> s32):
//   acc[co, p] = sum_k Wq[co, k] * X[k, p]
// A block computes BM output channels x 128 output pixels, 32 K per step,
// in one of two kernels:
//  - stride 1, dilation 1 (every int8 conv of the default W8A8 forward: the
//    decoders' growth convs, flow heads, up-feat phase convs and context
//    conv 1): the STAGED kernel. Its pixel tile is R rows x C columns of one
//    image (C a multiple of 16, R*C <= 128, picked by
//    kernels/conv_chain_q8.py:staged_tile_q8). K runs channel chunk first,
//    then tap: for each chunk of 32 input channels the block copies the
//    tile's input window with its one-pixel halo, [32][R+2][C+32] bytes,
//    into shared memory once (16-byte loads when rows, segment bases and
//    batch strides are 16-byte aligned, byte loads otherwise; zeros outside
//    the image and past Cin). Each of the 9 taps copies its shifted window
//    of the halo into the X slab transposed: a thread gathers 16 channels
//    of one pixel, one byte each, into one 16-byte vector, so the slab is
//    K-contiguous, the layout int8 WMMA reads natively (a pixel-contiguous
//    slab, copied by 16-pixel vectors with a funnel shift, measured 1.5x
//    slower over the W8A8 forward's convs: WMMA then loads its B fragments
//    byte by byte). The weights are packed per tap with Cin padded to 32
//    ([cout_pad, 9, Cin32]), so the 32 K bytes of (co, tap, chunk) are two
//    aligned 16-byte vectors. Each input byte crosses from L2 once per
//    chunk instead of 9 times, and the segment lookup is made once per
//    channel and chunk.
//  - stride 2 or dilated (the opt-in 'enc' stride-2 convs and 'ctx' dilated
//    convs): the GATHER kernel, k = tap*Cin + c. Pixels flattened over
//    (b, y, x); each thread gathers 16 consecutive K values of one pixel,
//    one byte load each, decoding (tap, channel, segment) incrementally, one
//    step ahead in registers while the tensor cores work.
// Shared memory keeps each 16-deep K slab so that every 16x16 WMMA tile is
// 256 contiguous bytes (WMMA wants 32-byte aligned tiles, and 16 int8
// columns are only 16 bytes): A row-major [m][16], B column-major [n][16].
//
// Epilogue, in fp32 with every rounding explicit (no FMA contraction), the
// same operations in the same order as the plain version, so int8 codes and
// bf16 outputs equal it bit for bit:
//   v = (float)acc * d[co] + b[co]   d = wscale/s_out, b = bias/s_out
//   v = v >= 0 ? v : v * 0.1f        (act)
//   int8: clip(rint(v), -127, 127)   bf16: round to nearest even
// |acc| <= 127 * 127 * 9 * Cin stays below 2^31 for every Cin < 14,000.
//
// Bound on the H100: operations for the decoder convs (K up to 9 * 565,
// 1979 dense int8 TOP/s). The staged kernel's window copies (16 byte loads
// per thread and tap) and WMMA's fragment loads share the shared-memory
// port, and the coarse levels launch too few blocks to fill the card; no
// mma.sync, wgmma, TMA or cp.async pipeline yet.

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAXSEG = 8;
constexpr int THREADS = 256;
constexpr int BN = 128;  // output pixels per block
constexpr int BK = 32;   // K per step: two 16-deep slabs
constexpr int LDP = 20;  // per-warp epilogue patch [16][LDP] int32

struct Segs {
  const void* ptr[MAXSEG];     // block base (batch 0, channel 0)
  long long bstride[MAXSEG];   // elements between batch entries
  int cstart[MAXSEG + 1];      // first K-channel of each segment; [n] = Cin
  int n;
};

template <int BM>
struct Cfg {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int FM = BM / (16 * WARPS_M);  // fragments per warp in M
  static constexpr int FN = BN / (16 * WARPS_N);  // fragments per warp in N
};

// The requantizing epilogue of one accumulator value (see the top).
__device__ __forceinline__ void store_out(void* out, long long o, int acc,
                                          float d, float b, int act, int out_q8) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), d), b);
  if (act) v = v >= 0.f ? v : __fmul_rn(v, 0.1f);
  if (out_q8)
    static_cast<int8_t*>(out)[o] = (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
  else
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
}

// ---- stride 2 or dilated: the per-byte im2col gather -----------------------

template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_q8_kernel(Segs segs, int Cin, int Hin, int Win,
                  const int8_t* __restrict__ wpk,  // [cout_pad, k9p]
                  int k9p, const float* __restrict__ dq,
                  const float* __restrict__ bq, void* __restrict__ out,
                  long long out_bstride, int out_q8, int cout, int B, int Ho,
                  int Wo, int stride, int dil, int act) {
  using namespace nvcuda;
  using C = Cfg<BM>;
  __shared__ __align__(256) signed char As[2][BM * 16];  // [kf][m][k]
  __shared__ __align__(256) signed char Bs[2][BN * 16];  // [kf][n][k]
  __shared__ __align__(256) int patch[THREADS / 32][16 * LDP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int how = Ho * Wo;
  const int P = B * how;
  const int p0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int K9 = 9 * Cin;
  const long long hw_in = (long long)Hin * Win;

  // this thread's im2col column (pixel nl) and K slab (kh: k0 + 16*kh ..)
  const int nl = tid & (BN - 1);
  const int kh = tid / BN;
  const int p = p0 + nl;
  const bool pvalid = p < P;
  int pb = 0, iy0 = 0, ix0 = 0;
  if (pvalid) {
    pb = p / how;
    const int rem = p - pb * how;
    const int py = rem / Wo;
    iy0 = py * stride - dil;
    ix0 = (rem - py * Wo) * stride - dil;
  }
  // gather state of the next element: tap, channel c in segment s (which
  // ends at cend), its pointer at spatial offset 0 and whether it is in
  // the image (inb, at spatial offset sp)
  int tap = 0, c = 16 * kh, s = 0, cend = 0;
  bool inb = false;
  long long sp = 0;
  const int8_t* cp = nullptr;
  auto seek = [&]() {
    while (c >= Cin) { c -= Cin; ++tap; }
    s = 0;
    while (c >= segs.cstart[s + 1]) ++s;
    cend = segs.cstart[s + 1];
    cp = static_cast<const int8_t*>(segs.ptr[s]) + pb * segs.bstride[s] +
         (long long)(c - segs.cstart[s]) * hw_in;
    const int dy = tap / 3;
    const int iy = iy0 + dy * dil, ix = ix0 + (tap - dy * 3) * dil;
    inb = pvalid && tap < 9 && iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
    sp = (long long)iy * Win + ix;
  };
  seek();

  uint4 ra = make_uint4(0, 0, 0, 0);  // one 16-byte weight vector
  uint32_t rb[4];                     // 16 gathered codes
  const bool aload = tid < 2 * BM;
  const int am = tid >> 1, akf = tid & 1;
  auto gather = [&](int k0) {
    if (aload)
      ra = *reinterpret_cast<const uint4*>(wpk + (long long)(m0 + am) * k9p +
                                           k0 + 16 * akf);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t v = inb ? (uint32_t)(uint8_t)cp[sp] : 0u;
        word |= v << (8 * t);
        ++c;
        cp += hw_in;
        if (c >= cend) seek();
      }
      rb[q] = word;
    }
    // skip the other slab's 16 K values
    c += 16;
    cp += 16 * hw_in;
    if (c >= cend) seek();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  gather(0);
  for (int k0 = 0; k0 < K9; k0 += BK) {
    if (aload) *reinterpret_cast<uint4*>(&As[akf][am * 16]) = ra;
    *reinterpret_cast<uint4*>(&Bs[kh][nl * 16]) =
        make_uint4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (k0 + BK < K9) gather(k0 + BK);
#pragma unroll
    for (int kf = 0; kf < 2; ++kf) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(a[i], &As[kf][(wm * C::FM + i) * 256], 16);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kf][(wn * C::FN + j) * 256], 16);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time
  int* pt = patch[warp];
#pragma unroll
  for (int i = 0; i < C::FM; ++i) {
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::store_matrix_sync(pt, acc[i][j], LDP, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + (wm * C::FM + i) * 16;
      const int nb = p0 + (wn * C::FN + j) * 16;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const int r = e >> 4, cx = e & 15;
        const int co = mb + r, pp = nb + cx;
        if (co < cout && pp < P) {
          const int b = pp / how;
          store_out(out, b * out_bstride + (long long)co * how + (pp - b * how),
                    pt[r * LDP + cx], dq[co], bq[co], act, out_q8);
        }
      }
      __syncwarp();
    }
  }
}

template <int BM>
void launch(const Segs& segs, int Cin, int Hin, int Win, const void* w,
            int k9p, const float* dq, const float* bq, void* out,
            long long out_bstride, int out_q8, int cout, int B, int Ho,
            int Wo, int stride, int dil, int act, cudaStream_t s) {
  const long long P = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((P + BN - 1) / BN), (unsigned)((cout + BM - 1) / BM));
  conv3x3_q8_kernel<BM><<<grid, THREADS, 0, s>>>(
      segs, Cin, Hin, Win, static_cast<const int8_t*>(w), k9p, dq, bq, out,
      out_bstride, out_q8, cout, B, Ho, Wo, stride, dil, act);
}

// ---- stride 1, dilation 1: the input tile staged once per chunk -----------

// These match kernels/conv_chain_q8.py (STAGE_Q8_*), which picks the tile.
constexpr int ST_CC = BK;            // input channels per chunk = K per step
constexpr int ST_ALIGN = 16;         // tile columns per vector: C is a multiple
constexpr int ST_EXTRA = 32;         // halo row = C + 32 positions
constexpr int ST_PLANE_MAX = 480;    // (R + 2) * (C + 32) of any tile
constexpr int ST_HALO = ST_CC * ST_PLANE_MAX;
using ocf::FastDiv;

// The halo tile of a chunk: [ST_CC][R+2][HP] bytes, HP = C + 32, halo
// position p of a row holding input column ox0 - 16 + p,
// so that 16-byte vectors of a 16-aligned row land 16-byte aligned. Tap
// (dy, dx) of output pixel (r, c) reads row r + dy, position c + dx + 15.
template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_q8_staged_kernel(Segs segs, int Cin, int H, int W,
                         const int8_t* __restrict__ wpk,  // [cout_pad, 9, cin32]
                         int cin32, const float* __restrict__ dq,
                         const float* __restrict__ bq, void* __restrict__ out,
                         long long out_bstride, int out_q8, int cout, int TR,
                         int TC, int tiles_y, int tiles_x, int vec, int act) {
  using namespace nvcuda;
  using C = Cfg<BM>;
  __shared__ __align__(256) signed char As[2][BM * 16];       // [kf][m][k]
  __shared__ __align__(256) signed char Bs[2][BN / 16][256];  // [kf][n/16][k][n%16]
  // the chunk's halo tile; after the K loop, the epilogue's patches
  __shared__ __align__(256) signed char halo[ST_HALO];
  __shared__ const int8_t* chan[ST_CC];  // channel planes of the chunk
  static_assert(THREADS / 32 * 16 * LDP * 4 <= ST_HALO, "patch");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const int oy0 = ty * TR, ox0 = tx * TC;
  const int m0 = blockIdx.y * BM;
  const int HR = TR + 2, HP = TC + ST_EXTRA, PL = HR * HP;
  const long long hw = (long long)H * W;

  // stage the halo tile of channels c0 .. c0+31
  const FastDiv div_hr(HR), div_w2(TC + 2), div_vr(HP / 16);
  auto stage = [&](int c0) {
    if (tid < ST_CC) {
      const int c = c0 + tid;
      const int8_t* p = nullptr;
      if (c < Cin) {
        int s = 0;
        while (c >= segs.cstart[s + 1]) ++s;
        p = static_cast<const int8_t*>(segs.ptr[s]) + b * segs.bstride[s] +
            (long long)(c - segs.cstart[s]) * hw;
      }
      chan[tid] = p;
    }
    __syncthreads();
    if (vec) {  // every 16 positions one 16-byte vector, all in or all out
      const int VR = HP / 16, n = ST_CC * HR * VR;
      for (int e0 = tid; e0 < n; e0 += 4 * THREADS) {
        uint4 v[4];
        int dst[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS;
          v[u] = make_uint4(0, 0, 0, 0);
          dst[u] = -1;
          if (e < n) {
            const int row = div_vr(e), vx = e - row * VR;
            const int cl = div_hr(row), hy = row - cl * HR;
            const int iy = oy0 - 1 + hy, ix = ox0 - 16 + 16 * vx;
            const int8_t* p = chan[cl];
            if (p && iy >= 0 && iy < H && ix >= 0 && ix < W)
              v[u] = *reinterpret_cast<const uint4*>(p + (long long)iy * W + ix);
            dst[u] = cl * PL + hy * HP + 16 * vx;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (dst[u] >= 0) *reinterpret_cast<uint4*>(halo + dst[u]) = v[u];
      }
    } else {  // positions 15 .. C+16 (input columns ox0-1 .. ox0+C), one by one
      const int W2 = TC + 2, n = ST_CC * HR * W2;
      for (int e0 = tid; e0 < n; e0 += 8 * THREADS) {
        signed char v[8];
        int dst[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * THREADS;
          v[u] = 0;
          dst[u] = -1;
          if (e < n) {
            const int row = div_w2(e), px = e - row * W2;
            const int cl = div_hr(row), hy = row - cl * HR;
            const int iy = oy0 - 1 + hy, ix = ox0 - 1 + px;
            const int8_t* p = chan[cl];
            if (p && iy >= 0 && iy < H && ix >= 0 && ix < W)
              v[u] = p[(long long)iy * W + ix];
            dst[u] = cl * PL + hy * HP + px + 15;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (dst[u] >= 0) halo[dst[u]] = v[u];
      }
    }
  };

  // A tap's X slab, column-major: thread (pixel vn of the tile, channels
  // wk0 .. wk0+15 of the chunk) reads halo position vc + dx + 15 of row
  // vr + dy in each of its 16 channel planes and stores the 16 bytes as one
  // vector at [kf][n/16][n%16][0..15]; pixels past the tile's R*C are
  // zeros. A warp reads 32 neighbouring bytes of one plane per load and
  // writes 512 contiguous bytes.
  const int vn = tid & (BN - 1), wk0 = (tid >> 7) * 16;
  const int vr = vn / TC, vc = vn - vr * TC;
  const bool vvalid = vn < TR * TC;
  const int voff = wk0 * PL + (vvalid ? vr * HP + vc : 0) + 15;
  signed char* vdst = &Bs[tid >> 7][vn >> 4][(vn & 15) * 16];
  auto window = [&](int tap) {
    const int dy = tap / 3, dx = tap - dy * 3;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(halo) + voff + dy * HP + dx;
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = src[(4 * q) * PL] | (unsigned)src[(4 * q + 1) * PL] << 8 |
             (unsigned)src[(4 * q + 2) * PL] << 16 | (unsigned)src[(4 * q + 3) * PL] << 24;
    uint4 o = make_uint4(w[0], w[1], w[2], w[3]);
    if (!vvalid) o = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(vdst) = o;
  };

  // the 32 K bytes of (co, tap, chunk c0): two aligned 16-byte vectors
  const bool aload = tid < 2 * BM;
  const int am = tid >> 1, akf = tid & 1;
  const int8_t* wrow = wpk + (long long)(m0 + am) * 9 * cin32 + 16 * akf;
  uint4 ra = make_uint4(0, 0, 0, 0);
  auto load_a = [&](int c0, int tap) {
    if (aload) ra = *reinterpret_cast<const uint4*>(wrow + tap * cin32 + c0);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  load_a(0, 0);
  for (int c0 = 0; c0 < Cin; c0 += ST_CC) {
    stage(c0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      if (aload) *reinterpret_cast<uint4*>(&As[akf][am * 16]) = ra;
      window(tap);
      __syncthreads();
      if (tap < 8)
        load_a(c0, tap + 1);
      else if (c0 + ST_CC < Cin)
        load_a(c0 + ST_CC, 0);
#pragma unroll
      for (int kf = 0; kf < 2; ++kf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[C::FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bf[C::FN];
#pragma unroll
        for (int i = 0; i < C::FM; ++i)
          wmma::load_matrix_sync(a[i], &As[kf][(wm * C::FM + i) * 256], 16);
#pragma unroll
        for (int j = 0; j < C::FN; ++j)
          wmma::load_matrix_sync(bf[j], &Bs[kf][wn * C::FN + j][0], 16);
#pragma unroll
        for (int i = 0; i < C::FM; ++i)
#pragma unroll
          for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: each warp stages one 16x16 fragment at a time in the halo's
  // space; lane holds pixel column (lane & 15) of rows (lane >> 4) + 2t
  int* pt = reinterpret_cast<int*>(halo) + warp * 16 * LDP;
#pragma unroll
  for (int j = 0; j < C::FN; ++j) {
    const int n = (wn * C::FN + j) * 16 + (lane & 15);
    const int r = n / TC, c = n - r * TC;
    const int oy = oy0 + r, ox = ox0 + c;
    const bool ok = n < TR * TC && oy < H && ox < W;
    const long long o = b * out_bstride + (long long)oy * W + ox;
#pragma unroll
    for (int i = 0; i < C::FM; ++i) {
      wmma::store_matrix_sync(pt, acc[i][j], LDP, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + (wm * C::FM + i) * 16;
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        const int rr = (lane >> 4) + 2 * t2;
        const int co = mb + rr;
        if (ok && co < cout)
          store_out(out, o + (long long)co * hw, pt[rr * LDP + (lane & 15)],
                    dq[co], bq[co], act, out_q8);
      }
      __syncwarp();
    }
  }
}

template <int BM>
void launch_staged(const Segs& segs, int Cin, int H, int W, const void* w,
                   int cin32, const float* dq, const float* bq, void* out,
                   long long out_bstride, int out_q8, int cout, int B, int tr,
                   int tc, int vec, int act, cudaStream_t s) {
  const int tiles_y = (H + tr - 1) / tr, tiles_x = (W + tc - 1) / tc;
  const dim3 grid((unsigned)((long long)B * tiles_y * tiles_x),
                  (unsigned)((cout + BM - 1) / BM));
  conv3x3_q8_staged_kernel<BM><<<grid, THREADS, 0, s>>>(
      segs, Cin, H, W, static_cast<const int8_t*>(w), cin32, dq, bq, out,
      out_bstride, out_q8, cout, tr, tc, tiles_y, tiles_x, vec, act);
}

}  // namespace

// One W8A8 conv: reads `nseg` int8 channel segments (ptrs[i] at batch
// stride bstrides[i], chans[i] channels, each [*, Hin, Win]
// channel-contiguous) and writes cout channels of [Ho, Wo] at `out` (batch
// stride out_bstride): int8 codes when out_q8, else bf16. dq, bq: fp32
// [cout]. cfg picks the couts per tile, 16 << cfg.
// w: int8 [cout_pad, k9p]. A conv of stride 1 and dilation 1 runs the
// staged kernel on tiles of tile_r x tile_c output pixels; its row co holds
// k = tap*Cin32 + c, Cin32 = Cin rounded up to 32 and k9p = 9*Cin32, zero
// for c >= Cin. Any other conv runs the gather kernel (the tile ignored);
// its row co holds k = tap*Cin + c, zero beyond 9*Cin.
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_conv3x3_q8(int cfg, int nseg, void** ptrs,
                              const long long* bstrides, const int* chans,
                              int B, int Hin, int Win, const void* w, int k9p,
                              int cout_pad, const void* dq, const void* bq,
                              void* out, long long out_bstride, int out_q8,
                              int cout, int Ho, int Wo, int stride, int dil,
                              int act, int tile_r, int tile_c, void* stream) {
  if (nseg < 1 || nseg > MAXSEG || cfg < 0 || cfg > 3 || cout < 1 || B < 1 ||
      Ho < 1 || Wo < 1 || stride < 1 || dil < 1)
    return (int)cudaErrorInvalidValue;
  const int bm = 16 << cfg;
  Segs segs;
  segs.n = nseg;
  segs.cstart[0] = 0;
  for (int i = 0; i < MAXSEG; ++i) {
    const bool used = i < nseg;
    segs.ptr[i] = used ? ptrs[i] : nullptr;
    segs.bstride[i] = used ? bstrides[i] : 0;
    segs.cstart[i + 1] = used ? segs.cstart[i] + chans[i] : 0x7fffffff;
  }
  const int Cin = segs.cstart[nseg];
  if (cout_pad % bm != 0 || cout_pad < cout) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = static_cast<const float*>(dq);
  const float* b = static_cast<const float*>(bq);
  if (stride == 1 && dil == 1) {
    const int cin32 = (Cin + ST_CC - 1) / ST_CC * ST_CC;
    if (Ho != Hin || Wo != Win || k9p != 9 * cin32 || tile_r < 1 ||
        tile_c < ST_ALIGN || tile_c % ST_ALIGN || tile_r * tile_c > BN ||
        (tile_r + 2) * (tile_c + ST_EXTRA) > ST_PLANE_MAX)
      return (int)cudaErrorInvalidValue;
    // 16-byte halo loads need 16-aligned rows, segment bases and batch strides
    int vec = Win % 16 == 0;
    for (int i = 0; i < nseg; ++i)
      vec &= reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 && bstrides[i] % 16 == 0;
    if (cfg == 0)
      launch_staged<16>(segs, Cin, Hin, Win, w, cin32, d, b, out, out_bstride,
                        out_q8, cout, B, tile_r, tile_c, vec, act, s);
    else if (cfg == 1)
      launch_staged<32>(segs, Cin, Hin, Win, w, cin32, d, b, out, out_bstride,
                        out_q8, cout, B, tile_r, tile_c, vec, act, s);
    else if (cfg == 2)
      launch_staged<64>(segs, Cin, Hin, Win, w, cin32, d, b, out, out_bstride,
                        out_q8, cout, B, tile_r, tile_c, vec, act, s);
    else
      launch_staged<128>(segs, Cin, Hin, Win, w, cin32, d, b, out, out_bstride,
                         out_q8, cout, B, tile_r, tile_c, vec, act, s);
    return (int)cudaGetLastError();
  }
  if (k9p % BK != 0 || k9p < 9 * Cin) return (int)cudaErrorInvalidValue;
  if (cfg == 0)
    launch<16>(segs, Cin, Hin, Win, w, k9p, d, b, out, out_bstride, out_q8,
               cout, B, Ho, Wo, stride, dil, act, s);
  else if (cfg == 1)
    launch<32>(segs, Cin, Hin, Win, w, k9p, d, b, out, out_bstride, out_q8,
               cout, B, Ho, Wo, stride, dil, act, s);
  else if (cfg == 2)
    launch<64>(segs, Cin, Hin, Win, w, k9p, d, b, out, out_bstride, out_q8,
               cout, B, Ho, Wo, stride, dil, act, s);
  else
    launch<128>(segs, Cin, Hin, Win, w, k9p, d, b, out, out_bstride, out_q8,
                cout, B, Ho, Wo, stride, dil, act, s);
  return (int)cudaGetLastError();
}
