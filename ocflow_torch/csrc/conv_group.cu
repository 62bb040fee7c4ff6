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
// convs. Both kernels below are implicit GEMMs with fp32 accumulation:
//   out[co, p] = sum_k W[k, co] * X[k, p],  k = tap*Cin + c,  tap = dy*3+dx
// A block computes a tile of output channels x output pixels (pixels
// flattened over (b, y, x), so small levels still fill tiles), staging a
// K-slab of the packed weight and of the implicit im2col matrix in shared
// memory per step. The im2col gather handles padding (= dilation), stride
// and the segment lookup.
//  - bf16: tensor cores through WMMA (mma.sync 16x16x16 bf16 -> fp32),
//    BM x 128 pixels x 32 K per step, eight warps; each thread gathers one
//    pixel's column and decodes (tap, channel, segment) incrementally, one
//    step ahead in registers. With NCHW blocks every im2col element is a
//    separate 2-byte load: that gather, not the tensor cores, is what
//    holds the wide decoder convs far under the bound today.
//  - fp32: the CUDA cores, BM x BN tiles of 256 threads with TM x TN
//    register tiles (fp32 runs only to check the algorithm).
// No wgmma, TMA, channels-last vector gathers or shared-memory pipeline
// yet, and the chain is not kept on chip between its convs.

#include <mma.h>

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

}  // namespace

// One conv: reads `nseg` channel segments (ptrs[i] at batch stride
// bstrides[i], chans[i] channels, each [*, Hin, Win] channel-contiguous),
// writes cout channels of [Ho, Wo] at `out` with batch stride out_bstride.
// w: [9*Cin, cout_pad] in the input dtype; bias: fp32 [cout].
// cfg picks the couts per tile, 16 << cfg (fp32 tiles stop at 64);
// cout_pad must be a multiple of 16 << cfg.
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_conv3x3(int dtype, int cfg, int nseg, void** ptrs,
                           const long long* bstrides, const int* chans, int B,
                           int Hin, int Win, const void* w, const void* bias,
                           void* out, long long out_bstride, int cout,
                           int cout_pad, int Ho, int Wo, int stride, int dil,
                           int act, void* stream) {
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
  if (dtype == ocf::kF32 && cfg == 0)
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
