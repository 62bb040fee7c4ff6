// Cost-volume backward for Hopper (sm_90a).
//
// Replaces the VJP of ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `cost_volume_fused` (`_bwd` -> `_bwd_xla_mirror`, (2d+1)^2 shifted
// products in XLA). For features f1, f2 [B, C, H, W] and the cotangent g of
// the cost volume [B, (2d+1)^2, H, W] (channel k = i*(2d+1) + j):
//
//   df1[b,c,y,x] = (1/C) sum_{i,j} g[b,k,y,x]           * f2[b,c,y+i-d,x+j-d]
//   df2[b,c,y,x] = (1/C) sum_{i,j} g[b,k,y-i+d,x-j+d]   * f1[b,c,y-i+d,x-j+d]
//
// with every tap outside the image zero; fp32 accumulation, stored in the
// input dtype. Every displacement from 1 to 10 is compiled, one
// configuration line each: d=4 (FlowNetCV's training step and the d=4
// nets) and d=10 (a gradient through the FlowNetC family) as tuned, the
// others with the same configuration. d > 10 is not built (a thread keeps
// the step's (2d+1) x 4 cotangent values in registers; at d=10 the fp32
// kernel already spills).
//
// Bound on the H100. At d=4 bytes: it reads g (81 values per pixel) and
// f1, f2 once and writes df1, df2 once, against 4*81 operations per
// (channel, pixel), ~8 flop per byte in bf16, far under the ~295 flop/byte
// balance point. At d=10 and C=256 fp32 operations: 4*441*C*B*H*W = 2.59e10
// at 8x256x56x128, 0.386 ms at 67 TFLOP/s, against 336 MB (0.100 ms at
// 3.35 TB/s).
//
// Design (gather form: every output element is computed by one thread and
// written once, no atomics, so the result is deterministic). A block owns
// a band of R rows, a 32-column strip and CB channels of one image, and
// computes df1 or df2 there (the grid's z: image x {df1, df2}; channel
// groups are the fastest grid index, so the blocks that read one cotangent
// tile run together). It streams over the 2d+1 shift rows i: per step it
// stages the 2d+1 cotangent channels k = i*N .. i*N+N-1 of its band
// ([N][R][32], 2d+1 channels, not (2d+1)^2: shared memory grows with N) and
// one new feature row per channel. The feature rows stay on chip across the
// steps in a ring of R rows per channel: the band's rows of f2 for df1
// (row y+i-d) and of f1 for df2 (row y+d-i, i taken downwards) slide by one
// row per step, so each feature row is staged once per block. For df2 the
// cotangent of channel i*N+j is staged shifted by d-j columns, so that both
// outputs read the same aligned layout:
//   df1: acc[c][x] += G[j][x] * F[c][x + j]         (window from x - d)
//   df2: acc[c][x] += G[j][x] * F[c][x + 2d - j]
// A thread owns P=4 adjacent columns of CH channels of one row: per step
// it holds the step's N x 4 cotangent values in registers and, per channel,
// reads its 4+2d feature window (2d rounded up to whole float4s, as the
// staged rows are) as float4s for 4*N FMAs. The staging reads
// 16-byte vectors where a row is aligned, up to 8 in flight per thread, as
// the forward does.
//
//   d   R  CB  CH  threads  static smem  registers, spills (-Xptxas -v)
//   4   4  32   8    128     25,088 B    168, none
//  10   4  32   8    128     37,376 B    167 bf16, none; 168 fp32, 544 B
//
// Measured on an H100 SXM (700 W; `python -m
// ocflow_torch.tools.cost_volume_ablation`): the five d=4 calls of a
// training step 0.48 ms against 1.23 before; d=10 at 8x256x56x128 1.96 ms
// in fp32 (20% of its 0.386 ms bound) and 1.54 in bf16. With the staging
// taken out the FMAs take 0.62 ms at d=10 and 0.14 at d=4: the rest is the
// L2 latency of each step's staging, exposed at its barriers, as in the
// forward; overlapping it is the next step. Steps measured alone at d=10
// (fp32 / bf16, before the staging was batched): one row a block, one
// column and channel a thread 17.5 / 6.1 ms; the ring of rows 8.9 / 8.0;
// with 4 columns and 8 channels a thread 2.31 / 1.68.

#include <cstdint>

#include "cv_stage.cuh"

namespace {

constexpr int TW = 32;  // output columns per block

// Configuration (R, CB, CH, P, min blocks per SM, vectors per thread in
// flight while staging), one line for every d (tuned at d=4 and d=10, where
// the same values won):
#define CV_BWD 4, 32, 8, 4, 3, 8

// 2d rounded up to whole float4s: the staged feature rows are 32 + PAD wide
template <int D> constexpr int kPad = (2 * D + 3) / 4 * 4;

template <typename T, int D, int R, int CB, int CH, int P, int BATCH, bool DF2>
__device__ __forceinline__ void bwd_body(const T* __restrict__ feat, const T* __restrict__ g,
                                         T* __restrict__ dout, float* sf, float* sg, int b,
                                         int c0, int x0, int y0, int C, int H, int W,
                                         bool vec) {
  constexpr int N = 2 * D + 1;
  constexpr int CG = TW / P, NS = CB / CH;
  constexpr int WIN = TW + kPad<D>;
  constexpr int NW = P + kPad<D>;
  constexpr int NT = CG * NS * R;  // threads
  const int cg = threadIdx.x % CG;
  const int s = (threadIdx.x / CG) % NS;
  const int r = threadIdx.x / (CG * NS);
  const long long hw = (long long)H * W;
  const int nch = min(CB, C - c0);
  const T* fb = feat + ((long long)b * C + c0) * hw;

  float acc[CH][P];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[ch][p] = 0.f;

  // feature row q (image row y0 - D + q) lives in ring slot q % R
  for (int q = 0; q < R - 1; ++q)
    ocf::stage_rows<T, WIN, 1, CB, NT, BATCH>(sf + (q % R) * WIN, R * WIN, fb, hw, H, W, nch,
                                       y0 - D + q, x0 - D, 0, vec);
  for (int st = 0; st < N; ++st) {
    const int i = DF2 ? N - 1 - st : st;
    const int q = st + R - 1;
    ocf::stage_rows<T, WIN, 1, CB, NT, BATCH>(sf + (q % R) * WIN, R * WIN, fb, hw, H, W, nch,
                                       y0 - D + q, x0 - D, 0, vec);
    const T* gk = g + ((long long)b * N * N + (long long)i * N) * hw;
    if (DF2)  // sg[j][r][t] = g[i*N + j, y0 + r + d - i, x0 + t + d - j]
      ocf::stage_rows<T, TW, R, N, NT, BATCH>(sg, R * TW, gk, hw, H, W, N, y0 + D - i, x0 + D, -1,
                                       vec);
    else      // sg[j][r][t] = g[i*N + j, y0 + r, x0 + t]
      ocf::stage_rows<T, TW, R, N, NT, BATCH>(sg, R * TW, gk, hw, H, W, N, y0, x0, 0, vec);
    __syncthreads();

    float gv[N][P];
#pragma unroll
    for (int j = 0; j < N; ++j) ocf::lds<P>(sg + (j * R + r) * TW + cg * P, gv[j]);
    const float* frow = sf + ((r + st) % R) * WIN + cg * P;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      float w[NW];
#pragma unroll
      for (int v = 0; v < NW; v += P) ocf::lds<P>(frow + (s * CH + ch) * R * WIN + v, w + v);
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int p = 0; p < P; ++p)
          acc[ch][p] = fmaf(gv[j][p], w[p + (DF2 ? 2 * D - j : j)], acc[ch][p]);
    }
    __syncthreads();
  }

  const int y = y0 + r, x = x0 + cg * P;
  if (y < H && x < W) {
    const float inv_c = 1.f / (float)C;
    const int n = min(P, W - x);
    const bool whole = n == P && W % P == 0;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = c0 + s * CH + ch;
      if (c < C)
        ocf::store_cols<T, P>(dout + ((long long)b * C + c) * hw + (long long)y * W + x,
                              acc[ch], inv_c, n, whole);
    }
  }
}

template <typename T, int D, int R, int CB, int CH, int P, int MINB, int BATCH>
__global__ void __launch_bounds__((TW / P) * R * (CB / CH), MINB)
cost_volume_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       const T* __restrict__ g, T* __restrict__ df1,
                       T* __restrict__ df2, int C, int H, int W, int strips, bool vec) {
  static_assert((TW + kPad<D>) % 4 == 0 && kPad<D> % P == 0 && CB % CH == 0, "layout");
  __shared__ __align__(16) float sf[CB * R * (TW + kPad<D>)];  // feature rows, a ring
  __shared__ __align__(16) float sg[(2 * D + 1) * R * TW];   // one step's cotangent
  const int c0 = blockIdx.x * CB;
  const int x0 = (blockIdx.y % strips) * TW;
  const int y0 = (blockIdx.y / strips) * R;
  const int b = blockIdx.z >> 1;
  if (blockIdx.z & 1)
    bwd_body<T, D, R, CB, CH, P, BATCH, true>(f1, g, df2, sf, sg, b, c0, x0, y0, C, H, W, vec);
  else
    bwd_body<T, D, R, CB, CH, P, BATCH, false>(f2, g, df1, sf, sg, b, c0, x0, y0, C, H, W, vec);
}

template <int D, int R, int CB, int CH, int P, int MINB, int BATCH>
int launch(int dtype, const void* f1, const void* f2, const void* g, void* df1,
           void* df2, int B, int C, int H, int W, cudaStream_t s) {
  const int strips = (W + TW - 1) / TW;
  const long long tiles = (long long)strips * ((H + R - 1) / R);
  const int vec_elems = dtype == ocf::kF32 ? 4 : 8;
  const bool vec = W % vec_elems == 0 &&
                   ((uintptr_t)f1 | (uintptr_t)f2 | (uintptr_t)g) % 16 == 0;
  if (tiles > 65535 || 2LL * B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + CB - 1) / CB, (unsigned)tiles, 2 * B);
  const dim3 block((TW / P) * R * (CB / CH));
  if (dtype == ocf::kF32) {
    cost_volume_bwd_kernel<float, D, R, CB, CH, P, MINB, BATCH><<<grid, block, 0, s>>>(
        (const float*)f1, (const float*)f2, (const float*)g, (float*)df1, (float*)df2,
        C, H, W, strips, vec);
  } else if (dtype == ocf::kBF16) {
    cost_volume_bwd_kernel<__nv_bfloat16, D, R, CB, CH, P, MINB, BATCH><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (const __nv_bfloat16*)g,
        (__nv_bfloat16*)df1, (__nv_bfloat16*)df2, C, H, W, strips, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2, df1, df2: [B, C, H, W] contiguous; g: [B, (2d+1)^2, H, W]
// contiguous, all of one dtype; 1 <= d <= 10. Returns cudaGetLastError()
// after the launch.
extern "C" int ocf_cost_volume_bwd(int dtype, const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int C, int H, int W, int d, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch<1, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 2: return launch<2, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 3: return launch<3, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 4: return launch<4, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 5: return launch<5, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 6: return launch<6, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 7: return launch<7, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 8: return launch<8, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 9: return launch<9, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    case 10: return launch<10, CV_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
