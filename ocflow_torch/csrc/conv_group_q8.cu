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
//   acc[co, p] = sum_k Wq[co, k] * X[k, p],  k = tap*Cin + c,  tap = dy*3+dx
// A block computes BM output channels x 128 output pixels (pixels flattened
// over (b, y, x)), 32 K per step. Shared memory keeps each 16-deep K slab
// with K innermost (A row-major [m][16], B column-major [n][16]), so every
// 16x16 WMMA tile is 256 contiguous bytes and the weight rows load as
// 16-byte vectors. Each thread gathers 16 consecutive K values of one pixel
// (one 16-byte shared store), decoding (tap, channel, segment)
// incrementally, one step ahead in registers while the tensor cores work.
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
// 1979 dense int8 TOP/s); the gather of one byte per im2col element (NCHW
// blocks) is what holds it under that today, as in conv_group.cu. No wgmma,
// TMA or channels-last vector gathers yet.

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
          float v = __fadd_rn(__fmul_rn(__int2float_rn(pt[r * LDP + cx]), dq[co]),
                              bq[co]);
          if (act) v = v >= 0.f ? v : __fmul_rn(v, 0.1f);
          const long long o = b * out_bstride + (long long)co * how + (pp - b * how);
          if (out_q8)
            static_cast<int8_t*>(out)[o] =
                (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
          else
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
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

}  // namespace

// One W8A8 conv: reads `nseg` int8 channel segments (ptrs[i] at batch
// stride bstrides[i], chans[i] channels, each [*, Hin, Win]
// channel-contiguous) and writes cout channels of [Ho, Wo] at `out` (batch
// stride out_bstride): int8 codes when out_q8, else bf16.
// w: int8 [cout_pad, k9p], row co holding k = tap*Cin + c, zero beyond
// 9*Cin; dq, bq: fp32 [cout]. cfg picks the couts per tile, 16 << cfg.
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_conv3x3_q8(int cfg, int nseg, void** ptrs,
                              const long long* bstrides, const int* chans,
                              int B, int Hin, int Win, const void* w, int k9p,
                              int cout_pad, const void* dq, const void* bq,
                              void* out, long long out_bstride, int out_q8,
                              int cout, int Ho, int Wo, int stride, int dil,
                              int act, void* stream) {
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
  if (k9p % BK != 0 || k9p < 9 * Cin || cout_pad % bm != 0 || cout_pad < cout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = static_cast<const float*>(dq);
  const float* b = static_cast<const float*>(bq);
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
