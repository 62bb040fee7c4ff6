// One 3x3 convolution of a conv group, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocflow_tpu/ops/pallas/conv_chain_kernel.py
// `conv_group` (body `_kernel_body`): a chain of 3x3 convs whose DenseNet
// concat growth is a K-split over blocks of a shared channel stripe, with
// bias + LeakyReLU(0.1) fused, stride 2 and dilation. Here the Python
// wrapper (kernels/conv_chain.py) launches this kernel once per conv of the
// chain; every block lives in one [B, C_total, H, W] stripe in device
// memory, and a conv reads its input blocks as up to MAXSEG channel
// segments (the stripe's block ranges or separate kernel inputs), so the
// concat is never materialized.
//
// Bound on the H100: operations for the wide decoder convs (K = 9*Cin up
// to ~5000 against cout 32..128), bytes for the narrow encoder and head
// convs. The kernels below are implicit GEMMs with fp32 accumulation:
//   out[co, p] = sum_k W[k, co] * X[k, p],  k = tap*Cin + c,  tap = dy*3+dx
// over the packed weight [9*Cin, cout_pad]. A block computes BM output
// channels x 128 output pixels and steps through K 32 rows at a time,
// each step a [32 x BM] weight slab and a [32 x 128] slab of X in shared
// memory, multiplied on the tensor cores through WMMA (mma.sync 16x16x16
// bf16 -> fp32, eight warps). The three kernels differ in how they fill
// the X slab:
//  - bf16, stride 1, dilation 1 (every conv of the FlowNetCV decoders, the
//    context tail and the encoders' pair convs): the STAGED kernel. Its
//    pixel tile is R rows x C columns of one image (C a multiple of 8,
//    R*C <= 128, picked by kernels/conv_chain.py:staged_tile). K runs
//    channel chunk first, then tap: for each chunk of 32 input channels the
//    block copies the tile's input window with its one-pixel halo,
//    [32][R+2][C+2], into shared memory once (16-byte loads when the rows
//    and segments are 16-byte aligned, 2-byte loads otherwise; zeros
//    outside the image and past Cin), and each of the 9 taps copies its
//    shifted window of that halo into the aligned X slab by 16-byte
//    vectors, with a one-element funnel shift for dx = 0 and 2 (WMMA needs
//    32-byte aligned tiles, which a shifted window is not). The weight rows
//    of (chunk, tap) are rows
//    tap*Cin + c0 .. c0+31 of the same packed weight, zeroed past Cin (they
//    belong to the next tap). Each input element crosses from L2 once per
//    chunk instead of 9 times, (R+2)(C+2)/(R*C) loads per pixel and
//    channel, and the segment lookup is made once per channel and chunk.
//    The weight slab is read again for every pixel tile, and the window
//    copies and WMMA's fragment loads share the shared-memory port: those,
//    not global memory, bound it now.
//  - bf16, stride 2 or dilated (the encoders' first convs): the GATHER
//    kernel. Pixels flattened over (b, y, x); each thread gathers one
//    pixel's im2col column, decoding (tap, channel, segment) incrementally,
//    one step ahead in registers: a separate 2-byte load per element.
//  - fp32: the CUDA cores, BM x BN tiles of 256 threads with TM x TN
//    register tiles, the same gather (fp32 runs only to check the
//    algorithm).
// No wgmma, TMA, cp.async pipeline or channels-last blocks yet, and the
// chain is not kept on chip between its convs.

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAXSEG = 8;
constexpr int BK = 16;  // K per step of the fp32 kernel
constexpr int THREADS = 256;

struct Segs {
  const void* ptr[MAXSEG];     // block base (batch 0, channel 0)
  long long bstride[MAXSEG];   // elements between batch entries
  int cstart[MAXSEG + 1];      // first K-channel of each segment; [n] = Cin
  int n;
};

// ---- fp32 on the CUDA cores -----------------------------------------------

template <int TM, int TN>
__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(Segs segs, int Cin, int Hin, int Win,
                   const float* __restrict__ wpk,   // [9*Cin, cout_pad]
                   const float* __restrict__ bias,  // [cout]
                   float* __restrict__ out, long long out_bstride, int cout,
                   int cout_pad, int B, int Ho, int Wo, int stride, int dil,
                   int act) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  static_assert(THREADS % BN == 0, "pixel tile must divide the block");
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long how = (long long)Ho * Wo;
  const long long P = (long long)B * how;
  const long long p0 = (long long)blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int K9 = 9 * Cin;
  const long long hw_in = (long long)Hin * Win;

  // the output pixel whose im2col column this thread loads
  const int nl = tid % BN;
  const long long pl = p0 + nl;
  const bool pvalid = pl < P;
  int pb = 0, iy0 = 0, ix0 = 0;
  if (pvalid) {
    pb = (int)(pl / how);
    const int rem = (int)(pl - (long long)pb * how);
    const int py = rem / Wo;
    iy0 = py * stride - dil;
    ix0 = (rem - py * Wo) * stride - dil;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K9; k0 += BK) {
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e / BM, m = e - kk * BM;
      const int k = k0 + kk;
      As[kk][m] = k < K9 ? wpk[(long long)k * cout_pad + m0 + m] : 0.f;
    }
    for (int kk = tid / BN; kk < BK; kk += THREADS / BN) {
      const int k = k0 + kk;
      float v = 0.f;
      if (pvalid && k < K9) {
        const int tap = k / Cin;
        const int c = k - tap * Cin;
        const int dy = tap / 3;
        const int iy = iy0 + dy * dil;
        const int ix = ix0 + (tap - dy * 3) * dil;
        if (iy >= 0 && iy < Hin && ix >= 0 && ix < Win) {
          int s = 0;
          while (c >= segs.cstart[s + 1]) ++s;
          const float* base = static_cast<const float*>(segs.ptr[s]);
          v = base[pb * segs.bstride[s] + (long long)(c - segs.cstart[s]) * hw_in +
                   (long long)iy * Win + ix];
        }
      }
      Bs[kk][nl] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const long long p = p0 + tx + 16 * j;
    if (p >= P) continue;
    const int b = (int)(p / how);
    const long long rem = p - (long long)b * how;
    float* ob = out + b * out_bstride + rem;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int co = m0 + ty + 16 * i;
      if (co >= cout) continue;
      float v = acc[i][j] + bias[co];
      if (act) v = v >= 0.f ? v : 0.1f * v;
      ob[(long long)co * how] = v;
    }
  }
}

template <int TM, int TN>
void launch_f32(const Segs& segs, int Cin, int Hin, int Win, const void* w,
                const float* bias, void* out, long long out_bstride, int cout,
                int cout_pad, int B, int Ho, int Wo, int stride, int dil,
                int act, cudaStream_t s) {
  const long long P = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((P + 16 * TN - 1) / (16 * TN)),
                  (unsigned)((cout + 16 * TM - 1) / (16 * TM)));
  conv3x3_f32_kernel<TM, TN><<<grid, THREADS, 0, s>>>(
      segs, Cin, Hin, Win, (const float*)w, bias, (float*)out, out_bstride,
      cout, cout_pad, B, Ho, Wo, stride, dil, act);
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int TC_BN = 128;  // output pixels per block
constexpr int TC_BK = 32;   // K per step
constexpr int TC_BPT = TC_BK * TC_BN / THREADS;  // im2col elements per thread
constexpr int TC_LDP = 20;  // per-warp epilogue patch [16][TC_LDP] fp32

template <int BM>
struct TcCfg {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int FM = BM / (16 * WARPS_M);      // fragments per warp in M
  static constexpr int FN = TC_BN / (16 * WARPS_N);   // fragments per warp in N
  static constexpr int LDA = BM + 8;       // As[k][m], bf16 (col-major A)
  static constexpr int LDB = TC_BN + 8;    // Bs[k][n], bf16 (row-major B)
  // weight slab loaded as 16-byte vectors of 8 couts
  static constexpr int AVEC = TC_BK * BM / 8;
  static constexpr int AVPT = (AVEC + THREADS - 1) / THREADS;
};

// Per K step the block stages a [32 x BM] weight slab and a [32 x 128]
// im2col slab in shared memory. The gather of step t+1 is issued into
// registers before the MMAs of step t, so its global loads are in flight
// while the tensor cores work; each thread owns one pixel column and
// rows k = krow0 + 2i, and decodes (tap, channel, segment) incrementally.
template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_bf16_tc_kernel(Segs segs, int Cin, int Hin, int Win,
                       const __nv_bfloat16* __restrict__ wpk,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, long long out_bstride,
                       int cout, int cout_pad, int B, int Ho, int Wo,
                       int stride, int dil, int act) {
  using namespace nvcuda;
  using Cfg = TcCfg<BM>;
  __shared__ __align__(128) __nv_bfloat16 As[TC_BK * Cfg::LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[TC_BK * Cfg::LDB];
  __shared__ __align__(128) float patch[THREADS / 32][16 * TC_LDP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / Cfg::WARPS_N, wn = warp % Cfg::WARPS_N;
  const int how = Ho * Wo;
  const int P = B * how;
  const int p0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * BM;
  const int K9 = 9 * Cin;
  const long long hw_in = (long long)Hin * Win;

  const int nl = tid & (TC_BN - 1);
  const int krow0 = tid / TC_BN;
  constexpr int KSTEP = THREADS / TC_BN;
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
  // gather state of this thread's next im2col element: tap, channel c,
  // its segment s (channels below cend), the element pointer at spatial
  // offset 0 (cp) and whether the tap lands inside the image (inb, sp)
  int tap = 0, c = krow0, s = 0, cend = 0;
  bool inb = false;
  long long sp = 0;
  const __nv_bfloat16* cp = nullptr;
  const long long cstep = (long long)KSTEP * hw_in;
  auto seek = [&]() {
    while (c >= Cin) { c -= Cin; ++tap; }
    s = 0;
    while (c >= segs.cstart[s + 1]) ++s;
    cend = segs.cstart[s + 1];
    cp = static_cast<const __nv_bfloat16*>(segs.ptr[s]) + pb * segs.bstride[s] +
         (long long)(c - segs.cstart[s]) * hw_in;
    const int dy = tap / 3;
    const int iy = iy0 + dy * dil, ix = ix0 + (tap - dy * 3) * dil;
    inb = pvalid && tap < 9 && iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
    sp = (long long)iy * Win + ix;
  };
  seek();

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint4 ra[Cfg::AVPT];
  __nv_bfloat16 rb[TC_BPT];
  auto gather = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Cfg::AVPT; ++i) {
      const int e = tid + i * THREADS;  // vector id
      const int kk = e / (BM / 8), m = (e - kk * (BM / 8)) * 8;
      const int k = k0 + kk;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (e < Cfg::AVEC && k < K9)
        ra[i] = *reinterpret_cast<const uint4*>(wpk + (long long)k * cout_pad + m0 + m);
    }
#pragma unroll
    for (int i = 0; i < TC_BPT; ++i) {
      rb[i] = inb ? cp[sp] : zero;
      c += KSTEP;
      cp += cstep;
      if (c >= cend) seek();
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Cfg::FM][Cfg::FN];
#pragma unroll
  for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  gather(0);
  for (int k0 = 0; k0 < K9; k0 += TC_BK) {
#pragma unroll
    for (int i = 0; i < Cfg::AVPT; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / (BM / 8);
      if (e < Cfg::AVEC)
        *reinterpret_cast<uint4*>(As + kk * Cfg::LDA + (e - kk * (BM / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < TC_BPT; ++i) Bs[(krow0 + KSTEP * i) * Cfg::LDB + nl] = rb[i];
    __syncthreads();
    if (k0 + TC_BK < K9) gather(k0 + TC_BK);
#pragma unroll
    for (int kf = 0; kf < TC_BK / 16; ++kf) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[Cfg::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[Cfg::FN];
#pragma unroll
      for (int i = 0; i < Cfg::FM; ++i)
        wmma::load_matrix_sync(a[i], As + kf * 16 * Cfg::LDA + (wm * Cfg::FM + i) * 16, Cfg::LDA);
#pragma unroll
      for (int j = 0; j < Cfg::FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kf * 16 * Cfg::LDB + (wn * Cfg::FN + j) * 16, Cfg::LDB);
#pragma unroll
      for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
        for (int j = 0; j < Cfg::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time
  float* pt = patch[warp];
#pragma unroll
  for (int i = 0; i < Cfg::FM; ++i) {
#pragma unroll
    for (int j = 0; j < Cfg::FN; ++j) {
      wmma::store_matrix_sync(pt, acc[i][j], TC_LDP, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + (wm * Cfg::FM + i) * 16;
      const int nb = p0 + (wn * Cfg::FN + j) * 16;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const int r = e >> 4, cx = e & 15;
        const int co = mb + r, pp = nb + cx;
        if (co < cout && pp < P) {
          const int b = pp / how;
          float v = pt[r * TC_LDP + cx] + bias[co];
          if (act) v = v >= 0.f ? v : 0.1f * v;
          out[b * out_bstride + (long long)co * how + (pp - b * how)] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int BM>
void launch_tc(const Segs& segs, int Cin, int Hin, int Win, const void* w,
               const float* bias, void* out, long long out_bstride, int cout,
               int cout_pad, int B, int Ho, int Wo, int stride, int dil,
               int act, cudaStream_t s) {
  const long long P = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((P + TC_BN - 1) / TC_BN),
                  (unsigned)((cout + BM - 1) / BM));
  conv3x3_bf16_tc_kernel<BM><<<grid, THREADS, 0, s>>>(
      segs, Cin, Hin, Win, (const __nv_bfloat16*)w, bias,
      (__nv_bfloat16*)out, out_bstride, cout, cout_pad, B, Ho, Wo, stride,
      dil, act);
}

// ---- bf16, stride 1, dilation 1: the input tile staged once per chunk -----

// These match kernels/conv_chain.py (STAGE_*), which picks the tile.
constexpr int ST_CC = TC_BK;        // input channels per chunk = K per step
constexpr int ST_EXTRA = 16;        // halo row = C + 16 positions
constexpr int ST_PLANE_MAX = 432;   // (R + 2) * (C + 16) of any tile
constexpr int ST_HALO = ST_CC * ST_PLANE_MAX;
using ocf::FastDiv;

// The halo tile of a chunk: [ST_CC][R+2][HP], HP = C + 16, halo position p
// of a row holding input column ox0 - 8 + p, so that 16-byte vectors of an
// 8-aligned row land 16-byte aligned. Tap (dy, dx) of output pixel (r, c)
// reads row r + dy, position c + dx + 7. C is a multiple of 8.
template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_bf16_staged_kernel(Segs segs, int Cin, int H, int W,
                           const __nv_bfloat16* __restrict__ wpk,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out,
                           long long out_bstride, int cout, int cout_pad,
                           int TR, int TC, int tiles_y, int tiles_x, int vec,
                           int act) {
  using namespace nvcuda;
  using Cfg = TcCfg<BM>;
  __shared__ __align__(128) __nv_bfloat16 As[TC_BK * Cfg::LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[TC_BK * Cfg::LDB];
  // the chunk's halo tile; after the K loop, the epilogue's patches
  __shared__ __align__(128) __nv_bfloat16 halo[ST_HALO];
  __shared__ const __nv_bfloat16* chan[ST_CC];  // channel planes of the chunk
  static_assert(THREADS / 32 * 16 * TC_LDP * 4 <= ST_HALO * 2, "patch");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / Cfg::WARPS_N, wn = warp % Cfg::WARPS_N;
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
  const FastDiv div_hr(HR), div_w2(TC + 2), div_vr(HP / 8);
  auto stage = [&](int c0) {
    if (tid < ST_CC) {
      const int c = c0 + tid;
      const __nv_bfloat16* p = nullptr;
      if (c < Cin) {
        int s = 0;
        while (c >= segs.cstart[s + 1]) ++s;
        p = static_cast<const __nv_bfloat16*>(segs.ptr[s]) + b * segs.bstride[s] +
            (long long)(c - segs.cstart[s]) * hw;
      }
      chan[tid] = p;
    }
    __syncthreads();
    if (vec) {  // every 8 positions one 16-byte vector, all in or all out
      const int VR = HP / 8, n = ST_CC * HR * VR;
      for (int e0 = tid; e0 < n; e0 += 4 * THREADS) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS;
          v[u] = make_uint4(0, 0, 0, 0);
          if (e < n) {
            const int row = div_vr(e), vx = e - row * VR;
            const int cl = div_hr(row), hy = row - cl * HR;
            const int iy = oy0 - 1 + hy, ix = ox0 - 8 + 8 * vx;
            const __nv_bfloat16* p = chan[cl];
            if (p && iy >= 0 && iy < H && ix >= 0 && ix < W)
              v[u] = *reinterpret_cast<const uint4*>(p + (long long)iy * W + ix);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS;
          if (e < n) *reinterpret_cast<uint4*>(halo + 8 * e) = v[u];
        }
      }
    } else {  // positions 7 .. C+8 (input columns ox0-1 .. ox0+C), one by one
      const int W2 = TC + 2, n = ST_CC * HR * W2;
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int e0 = tid; e0 < n; e0 += 8 * THREADS) {
        __nv_bfloat16 v[8];
        int dst[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * THREADS;
          v[u] = zero;
          dst[u] = -1;
          if (e < n) {
            const int row = div_w2(e), px = e - row * W2;
            const int cl = div_hr(row), hy = row - cl * HR;
            const int iy = oy0 - 1 + hy, ix = ox0 - 1 + px;
            const __nv_bfloat16* p = chan[cl];
            if (p && iy >= 0 && iy < H && ix >= 0 && ix < W)
              v[u] = p[(long long)iy * W + ix];
            dst[u] = row * HP + px + 7;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (dst[u] >= 0) halo[dst[u]] = v[u];
      }
    }
  };

  // A tap's X slab, 8 columns at a time: columns c .. c+7 of one tile row
  // read halo positions c + 8 .. c + 15 (dx = 1, one aligned vector),
  // shifted down (dx = 0) or up (dx = 2) by one element with the word
  // beside that vector; columns past the tile's R*C are zeros.
  const int vn = (tid % (TC_BN / 8)) * 8, vk0 = tid / (TC_BN / 8);
  const int vr = vn / TC, vc = vn - vr * TC;
  const bool vvalid = vn < TR * TC;
  const int voff = vk0 * PL + (vvalid ? vr * HP + vc + 8 : 8);
  auto window = [&](int tap) {
    const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
    for (int i = 0; i < TC_BK * TC_BN / 8 / THREADS; ++i) {
      const int k = vk0 + i * (THREADS * 8 / TC_BN);
      const __nv_bfloat16* src = halo + voff + (k - vk0) * PL + dy * HP;
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      uint4 o = v;
      if (dx == 0) {
        const unsigned w = *reinterpret_cast<const unsigned*>(src - 2);
        o = make_uint4(__byte_perm(w, v.x, 0x5432), __byte_perm(v.x, v.y, 0x5432),
                       __byte_perm(v.y, v.z, 0x5432), __byte_perm(v.z, v.w, 0x5432));
      } else if (dx == 2) {
        const unsigned w = *reinterpret_cast<const unsigned*>(src + 8);
        o = make_uint4(__byte_perm(v.x, v.y, 0x5432), __byte_perm(v.y, v.z, 0x5432),
                       __byte_perm(v.z, v.w, 0x5432), __byte_perm(v.w, w, 0x5432));
      }
      if (!vvalid) o = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Bs + k * Cfg::LDB + vn) = o;
    }
  };

  // weight rows tap*Cin + c0 + kk, zero for c0 + kk >= Cin
  uint4 ra[Cfg::AVPT];
  auto load_a = [&](int c0, int tap) {
#pragma unroll
    for (int i = 0; i < Cfg::AVPT; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / (BM / 8), m = (e - kk * (BM / 8)) * 8;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (e < Cfg::AVEC && c0 + kk < Cin)
        ra[i] = *reinterpret_cast<const uint4*>(
            wpk + (long long)(tap * Cin + c0 + kk) * cout_pad + m0 + m);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Cfg::FM][Cfg::FN];
#pragma unroll
  for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_a(0, 0);
  for (int c0 = 0; c0 < Cin; c0 += ST_CC) {
    stage(c0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int i = 0; i < Cfg::AVPT; ++i) {
        const int e = tid + i * THREADS;
        const int kk = e / (BM / 8);
        if (e < Cfg::AVEC)
          *reinterpret_cast<uint4*>(As + kk * Cfg::LDA + (e - kk * (BM / 8)) * 8) = ra[i];
      }
      window(tap);
      __syncthreads();
      if (tap < 8)
        load_a(c0, tap + 1);
      else if (c0 + ST_CC < Cin)
        load_a(c0 + ST_CC, 0);
#pragma unroll
      for (int kf = 0; kf < TC_BK / 16; ++kf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[Cfg::FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[Cfg::FN];
#pragma unroll
        for (int i = 0; i < Cfg::FM; ++i)
          wmma::load_matrix_sync(a[i], As + kf * 16 * Cfg::LDA + (wm * Cfg::FM + i) * 16, Cfg::LDA);
#pragma unroll
        for (int j = 0; j < Cfg::FN; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kf * 16 * Cfg::LDB + (wn * Cfg::FN + j) * 16, Cfg::LDB);
#pragma unroll
        for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
          for (int j = 0; j < Cfg::FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: each warp stages one 16x16 fragment at a time in the halo's
  // space; lane holds pixel column (lane & 15) of rows (lane >> 4) + 2t
  float* pt = reinterpret_cast<float*>(halo) + warp * 16 * TC_LDP;
#pragma unroll
  for (int j = 0; j < Cfg::FN; ++j) {
    const int n = (wn * Cfg::FN + j) * 16 + (lane & 15);
    const int r = n / TC, c = n - r * TC;
    const int oy = oy0 + r, ox = ox0 + c;
    const bool ok = n < TR * TC && oy < H && ox < W;
    __nv_bfloat16* ob = out + b * out_bstride + (long long)oy * W + ox;
#pragma unroll
    for (int i = 0; i < Cfg::FM; ++i) {
      wmma::store_matrix_sync(pt, acc[i][j], TC_LDP, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + (wm * Cfg::FM + i) * 16;
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        const int rr = (lane >> 4) + 2 * t2;
        const int co = mb + rr;
        if (ok && co < cout) {
          float v = pt[rr * TC_LDP + (lane & 15)] + bias[co];
          if (act) v = v >= 0.f ? v : 0.1f * v;
          ob[(long long)co * hw] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int BM>
void launch_staged(const Segs& segs, int Cin, int H, int W, const void* w,
                   const float* bias, void* out, long long out_bstride,
                   int cout, int cout_pad, int B, int tr, int tc, int vec,
                   int act, cudaStream_t s) {
  const int tiles_y = (H + tr - 1) / tr, tiles_x = (W + tc - 1) / tc;
  const dim3 grid((unsigned)((long long)B * tiles_y * tiles_x),
                  (unsigned)((cout + BM - 1) / BM));
  conv3x3_bf16_staged_kernel<BM><<<grid, THREADS, 0, s>>>(
      segs, Cin, H, W, (const __nv_bfloat16*)w, bias, (__nv_bfloat16*)out,
      out_bstride, cout, cout_pad, tr, tc, tiles_y, tiles_x, vec, act);
}

}  // namespace

// One conv: reads `nseg` channel segments (ptrs[i] at batch stride
// bstrides[i], chans[i] channels, each [*, Hin, Win] channel-contiguous),
// writes cout channels of [Ho, Wo] at `out` with batch stride out_bstride.
// w: [9*Cin, cout_pad] in the input dtype; bias: fp32 [cout].
// cfg picks the couts per tile, 16 << cfg (fp32 tiles stop at 64);
// cout_pad must be a multiple of 16 << cfg. A bf16 conv of stride 1 and
// dilation 1 runs the staged kernel on tiles of tile_r x tile_c output
// pixels (ignored by the other kernels).
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_conv3x3(int dtype, int cfg, int nseg, void** ptrs,
                           const long long* bstrides, const int* chans, int B,
                           int Hin, int Win, const void* w, const void* bias,
                           void* out, long long out_bstride, int cout,
                           int cout_pad, int Ho, int Wo, int stride, int dil,
                           int act, int tile_r, int tile_c, void* stream) {
  if (nseg < 1 || nseg > MAXSEG || cfg < 0 || cfg > 3 || cout < 1 ||
      B < 1 || Ho < 1 || Wo < 1 || stride < 1 || dil < 1)
    return (int)cudaErrorInvalidValue;
  const int bm = 16 << cfg;
  if (cout_pad % bm != 0 || cout_pad < cout) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = static_cast<const float*>(bias);
  if (dtype == ocf::kBF16 && stride == 1 && dil == 1) {
    if (Ho != Hin || Wo != Win || tile_r < 1 || tile_c < 8 || tile_c % 8 ||
        tile_r * tile_c > TC_BN ||
        (tile_r + 2) * (tile_c + ST_EXTRA) > ST_PLANE_MAX)
      return (int)cudaErrorInvalidValue;
    // 16-byte halo loads need 8-aligned rows and segment planes
    int vec = Win % 8 == 0;
    for (int i = 0; i < nseg; ++i)
      vec &= reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 && bstrides[i] % 8 == 0;
    if (cfg == 0)
      launch_staged<16>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                        cout_pad, B, tile_r, tile_c, vec, act, s);
    else if (cfg == 1)
      launch_staged<32>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                        cout_pad, B, tile_r, tile_c, vec, act, s);
    else if (cfg == 2)
      launch_staged<64>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                        cout_pad, B, tile_r, tile_c, vec, act, s);
    else
      launch_staged<128>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                         cout_pad, B, tile_r, tile_c, vec, act, s);
  } else if (dtype == ocf::kF32 && cfg == 0)
    launch_f32<1, 8>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                     cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kF32 && cfg == 1)
    launch_f32<2, 8>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                     cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kF32)  // 64 couts per tile for cfg 2 and 3
    launch_f32<4, 4>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                     cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kBF16 && cfg == 0)
    launch_tc<16>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                  cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kBF16 && cfg == 1)
    launch_tc<32>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                  cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kBF16 && cfg == 2)
    launch_tc<64>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                  cout_pad, B, Ho, Wo, stride, dil, act, s);
  else if (dtype == ocf::kBF16)
    launch_tc<128>(segs, Cin, Hin, Win, w, b, out, out_bstride, cout,
                   cout_pad, B, Ho, Wo, stride, dil, act, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
