// Cost-volume forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `_forward_pallas` (body `_kernel`): for every pixel, all (2d+1)^2
// correlations  out[b, i*(2d+1)+j, y, x] = mean_c f1[b,c,y,x] *
// f2[b,c,y+i-d,x+j-d]  with f2 zero-padded, accumulated in fp32 and written
// in the input dtype. Layout NCHW in, [B, (2d+1)^2, H, W] out. Every
// displacement from 1 to 10 is compiled, one configuration line each: d=4
// (81 shifts, FlowNetCV and the d=4 nets) and d=10 (441 shifts, the
// FlowNetC family's 1/8-resolution correlation) as tuned, the others for
// any net built with another `displacement`. d > 10 is not built: a thread
// keeps (2d+1) x 4 fp32 sums in registers, and at d=10 the fp32 kernel
// already spills at the 128-register cap of two blocks per SM.
//
// Bound on the H100. At d=4 bytes: it reads 2*B*C*H*W and writes
// 81*B*H*W elements against 2*81*C operations per pixel (about 5 flop per
// byte at C=32 in bf16, far under the card's ~295 flop/byte balance
// point). At d=10 and C=256 in fp32 the 441 shifts make it 2*441*C
// operations per pixel against about 3.8 KB moved: fp32 operations bound
// it (59 flop per byte against the CUDA cores' 67 TFLOP/s over 3.35 TB/s,
// 20), 0.193 ms at 8x256x56x128.
//
// Design. A block owns a band of R output rows, a 32-column strip and IS
// of the 2d+1 shift rows i (the grid's z splits the shift rows into groups
// to fill the card at d=10, where 8x56x4 row-strips are few; output
// channels are independent, so no cross-block sum; where IS does not
// divide 2d+1 the last group's surplus rows are computed and not stored).
// Per chunk of CC
// channels it stages f1's R rows x 32 columns and f2's R+IS-1 rows x
// (32+2d, rounded up to a multiple of 4) columns once in shared memory as
// fp32 (zero outside the image),
// so each f2 row comes from L2 (R+IS-1)/R times per shift group instead of
// 2d+1 times. The staging reads 16-byte vectors where a row is aligned (W
// a multiple of 16 bytes), a few in flight per thread before it stores
// them, and one element otherwise; the counts and divisors are
// compile-time constants. A thread owns P=4 adjacent output columns of one
// (row, shift row): per channel it reads its 4 f1 values and its 4+2d f2
// window (rounded up to whole float4s) as float4s and does 4*(2d+1) FMAs
// on registers, 84 per 7 vector
// reads at d=10 (12 per read at d=4), where the kernel before this design
// read one shared float per FMA. Each output is the fp32 sum over channels
// divided by C, written once, 4 columns per store.
//
//   d   R  IS  CC  threads  static smem  registers, spills (-Xptxas -v)
//   4   4   9  16    288     38,912 B    96 bf16 / 95 fp32, none
//  10   4   7  16    224     41,472 B    128 (the cap for 2 blocks), 76 B
//
// Measured on an H100 SXM (700 W; `python -m
// ocflow_torch.tools.cost_volume_ablation`): at d=10, 8x256x56x128 fp32,
// 0.81 ms against 3.07 before, 24% of the bound; the same kernel with its
// staging taken out runs the FMAs in 0.375 ms, so most of the rest is the
// L2 latency of each chunk's staging, exposed at its barrier with two
// blocks per SM. Overlapping it (cp.async or TMA into a second buffer) is
// the next step. Steps measured alone (before the staging was batched):
// rows on chip with one column a thread 1.33 ms, one row a block and one
// column a thread 1.93, both with the 4-column blocking 0.97.
//
// Tensor cores are not used: for fp32 inputs a TF32 or bf16 product would
// be another result than the JAX package serves.

#include <cstdint>

#include "cv_stage.cuh"

namespace {

constexpr int TW = 32;  // output columns per block

// Configurations (R, IS, CC, P, min blocks per SM, vectors per thread in
// flight while staging), one line per d; IS divides 2d+1 where a divisor
// gives 96-288 threads, else the last group has a surplus row or two:
#define CV_FWD_D1 4, 3, 16, 4, 2, 2
#define CV_FWD_D2 4, 5, 16, 4, 2, 2
#define CV_FWD_D3 4, 7, 16, 4, 2, 2
#define CV_FWD_D4 4, 9, 16, 4, 2, 2
#define CV_FWD_D5 4, 6, 16, 4, 2, 4
#define CV_FWD_D6 4, 7, 16, 4, 2, 4
#define CV_FWD_D7 4, 5, 16, 4, 2, 4
#define CV_FWD_D8 4, 6, 16, 4, 2, 4
#define CV_FWD_D9 4, 5, 16, 4, 2, 4
#define CV_FWD_D10 4, 7, 16, 4, 2, 4

template <typename T, int D, int R, int IS, int CC, int P, int MINB, int BATCH>
__global__ void __launch_bounds__(R * IS * (TW / P), MINB)
cost_volume_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       T* __restrict__ out, int C, int H, int W, bool vec) {
  constexpr int N = 2 * D + 1;         // shifts per axis
  constexpr int CG = TW / P;           // column groups per row
  constexpr int PAD = (2 * D + 3) / 4 * 4;  // 2d rounded up to whole float4s
  constexpr int WIN = TW + PAD;        // f2 window columns
  constexpr int R2 = R + IS - 1;       // f2 rows per band and shift group
  constexpr int NW = P + PAD;          // a thread's f2 window
  constexpr int NT = R * IS * CG;      // threads
  static_assert(IS <= N && WIN % 4 == 0 && PAD % P == 0, "layout");
  __shared__ __align__(16) float s1[CC * R * TW];
  __shared__ __align__(16) float s2[CC * R2 * WIN];

  const int groups = (N + IS - 1) / IS;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * R;
  const int i0 = (blockIdx.z % groups) * IS;
  const int b = blockIdx.z / groups;
  const int cg = threadIdx.x % CG;
  const int q = threadIdx.x / CG;
  const int ii = q % IS, r = q / IS;
  const long long hw = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * hw;
  const T* f2b = f2 + (long long)b * C * hw;

  float acc[N][P];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[j][p] = 0.f;

  const float* a_row = s1 + r * TW + cg * P;
  const float* w_row = s2 + (r + ii) * WIN + cg * P;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nch = min(CC, C - c0);
    ocf::stage_rows<T, TW, R, CC, NT, BATCH>(s1, R * TW, f1b + c0 * hw, hw, H, W, nch, y0, x0, 0,
                                      vec);
    ocf::stage_rows<T, WIN, R2, CC, NT, BATCH>(s2, R2 * WIN, f2b + c0 * hw, hw, H, W, nch,
                                        y0 + i0 - D, x0 - D, 0, vec);
    __syncthreads();
    for (int cc = 0; cc < nch; ++cc) {
      float a[P], w[NW];
      ocf::lds<P>(a_row + cc * R * TW, a);
#pragma unroll
      for (int v = 0; v < NW; v += P) ocf::lds<P>(w_row + cc * R2 * WIN + v, w + v);
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[j][p] = fmaf(a[p], w[p + j], acc[j][p]);
    }
    __syncthreads();
  }

  const int y = y0 + r, x = x0 + cg * P;
  if (y < H && x < W && (N % IS == 0 || i0 + ii < N)) {
    const float cf = (float)C;
    const int n = min(P, W - x);
    const bool whole = n == P && W % P == 0;
    T* ob = out + ((long long)b * N * N + (long long)(i0 + ii) * N) * hw + (long long)y * W + x;
#pragma unroll
    for (int j = 0; j < N; ++j) ocf::store_mean<T, P>(ob + j * hw, acc[j], cf, n, whole);
  }
}

template <int D, int R, int IS, int CC, int P, int MINB, int BATCH>
int launch(int dtype, const void* f1, const void* f2, void* out, int B, int C,
           int H, int W, cudaStream_t s) {
  const long long z = (long long)B * ((2 * D + IS) / IS);
  const int vec_elems = dtype == ocf::kF32 ? 4 : 8;
  const bool vec = W % vec_elems == 0 && ((uintptr_t)f1 | (uintptr_t)f2) % 16 == 0;
  if (z > 65535 || (H + R - 1) / R > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + R - 1) / R, (unsigned)z);
  const dim3 block(R * IS * (TW / P));
  if (dtype == ocf::kF32) {
    cost_volume_fwd_kernel<float, D, R, IS, CC, P, MINB, BATCH><<<grid, block, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, C, H, W, vec);
  } else if (dtype == ocf::kBF16) {
    cost_volume_fwd_kernel<__nv_bfloat16, D, R, IS, CC, P, MINB, BATCH><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (__nv_bfloat16*)out, C, H,
        W, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: [B, C, H, W] contiguous; out: [B, (2d+1)^2, H, W] contiguous;
// 1 <= d <= 10. Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_fwd(int dtype, const void* f1, const void* f2,
                                   void* out, int B, int C, int H, int W,
                                   int d, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch<1, CV_FWD_D1>(dtype, f1, f2, out, B, C, H, W, s);
    case 2: return launch<2, CV_FWD_D2>(dtype, f1, f2, out, B, C, H, W, s);
    case 3: return launch<3, CV_FWD_D3>(dtype, f1, f2, out, B, C, H, W, s);
    case 4: return launch<4, CV_FWD_D4>(dtype, f1, f2, out, B, C, H, W, s);
    case 5: return launch<5, CV_FWD_D5>(dtype, f1, f2, out, B, C, H, W, s);
    case 6: return launch<6, CV_FWD_D6>(dtype, f1, f2, out, B, C, H, W, s);
    case 7: return launch<7, CV_FWD_D7>(dtype, f1, f2, out, B, C, H, W, s);
    case 8: return launch<8, CV_FWD_D8>(dtype, f1, f2, out, B, C, H, W, s);
    case 9: return launch<9, CV_FWD_D9>(dtype, f1, f2, out, B, C, H, W, s);
    case 10: return launch<10, CV_FWD_D10>(dtype, f1, f2, out, B, C, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
