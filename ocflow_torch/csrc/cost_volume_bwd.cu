// Cost-volume backward for Hopper (sm_90a).
//
// Replaces the VJP of ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `cost_volume_fused` (`_bwd` -> `_bwd_xla_mirror`, 81 shifted products in
// XLA). For features f1, f2 [B, C, H, W] and the cotangent g of the cost
// volume [B, (2d+1)^2, H, W] (channel k = i*(2d+1) + j):
//
//   df1[b,c,y,x] = (1/C) sum_{i,j} g[b,k,y,x]           * f2[b,c,y+i-d,x+j-d]
//   df2[b,c,y,x] = (1/C) sum_{i,j} g[b,k,y-i+d,x-j+d]   * f1[b,c,y-i+d,x-j+d]
//
// with every tap outside the image zero; fp32 accumulation, stored in the
// input dtype.
//
// Bound on the H100: memory. It reads g (81 values per pixel) and f1, f2
// once and writes df1, df2 once, against 4*81 operations per (channel,
// pixel): ~8 flop per byte at bf16, far under the ~295 flop/byte balance
// point.
//
// Design (gather form: every output element is computed by one thread and
// written once, no atomics, so the result is deterministic): one block per
// (batch, row y, 32-column strip), eight warps. The block stages in shared
// memory the 81 cotangent channels at (y, strip) for df1, and for df2 the
// cotangent row each shift reads (channel k at row y+d-i, 32+2d columns);
// then, per chunk of eight channels (one per warp), f1's and f2's
// (2d+1)-row x (32+2d)-column windows. Lane = column, warp = channel: each
// thread sums its 81 shifts of df1 and of df2 in registers. The windows of
// neighbouring rows are re-read from L2 by the blocks of those rows;
// keeping them on chip is the step towards the bound.

#include "common.cuh"

namespace {

constexpr int D = 4;             // max displacement of the FlowNetCV path
constexpr int N = 2 * D + 1;     // shifts per axis
constexpr int NK = N * N;        // cost-volume channels
constexpr int TW = 32;           // output columns per block (one per lane)
constexpr int WIN = TW + 2 * D;  // window columns
constexpr int CW = 8;            // channels per chunk (one per warp)

template <typename T>
__global__ void __launch_bounds__(CW * 32)
cost_volume_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       const T* __restrict__ g, T* __restrict__ df1,
                       T* __restrict__ df2, int C, int H, int W) {
  __shared__ float sg[NK][TW];       // g[k, y, x0 + lane]
  __shared__ float sgw[NK][WIN];     // g[k, y + d - i, x0 - d + u], k = i*N + j
  __shared__ float s1[CW][N][WIN];   // f1[c, y - d + r, x0 - d + u]
  __shared__ float s2[CW][N][WIN];   // f2[c, y - d + r, x0 - d + u]

  const int x0 = blockIdx.x * TW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long hw = (long long)H * W;
  const T* gb = g + (long long)b * NK * hw;
  const T* f1b = f1 + (long long)b * C * hw;
  const T* f2b = f2 + (long long)b * C * hw;

  for (int e = threadIdx.x; e < NK * TW; e += blockDim.x) {
    const int k = e / TW, xx = e - k * TW, x = x0 + xx;
    sg[k][xx] = x < W ? ocf::to_f32(gb[k * hw + (long long)y * W + x]) : 0.f;
  }
  for (int e = threadIdx.x; e < NK * WIN; e += blockDim.x) {
    const int k = e / WIN, u = e - k * WIN;
    const int yy = y + D - k / N, x = x0 - D + u;
    const bool in = yy >= 0 && yy < H && x >= 0 && x < W;
    sgw[k][u] = in ? ocf::to_f32(gb[k * hw + (long long)yy * W + x]) : 0.f;
  }

  const float inv_c = 1.f / (float)C;
  const int x = x0 + lane;
  for (int c0 = 0; c0 < C; c0 += CW) {
    __syncthreads();  // the previous chunk's windows are no longer read
    for (int e = threadIdx.x; e < CW * N * WIN; e += blockDim.x) {
      const int u = e % WIN;
      const int r = (e / WIN) % N;
      const int cc = e / (WIN * N);
      const int c = c0 + cc, yy = y - D + r, xx = x0 - D + u;
      const bool in = c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const long long off = c * hw + (long long)yy * W + xx;
      s1[cc][r][u] = in ? ocf::to_f32(f1b[off]) : 0.f;
      s2[cc][r][u] = in ? ocf::to_f32(f2b[off]) : 0.f;
    }
    __syncthreads();
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int k = i * N + j;
        a1 = fmaf(sg[k][lane], s2[w][i][lane + j], a1);
        a2 = fmaf(sgw[k][lane + 2 * D - j], s1[w][2 * D - i][lane + 2 * D - j], a2);
      }
    }
    const int c = c0 + w;
    if (c < C && x < W) {
      const long long off = (long long)b * C * hw + c * hw + (long long)y * W + x;
      df1[off] = ocf::from_f32<T>(a1 * inv_c);
      df2[off] = ocf::from_f32<T>(a2 * inv_c);
    }
  }
}

}  // namespace

// f1, f2, df1, df2: [B, C, H, W] contiguous; g: [B, (2d+1)^2, H, W]
// contiguous, all of one dtype. Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_bwd(int dtype, const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int C, int H, int W, int d, void* stream) {
  if (d != D || B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, H, B);
  const dim3 block(CW * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ocf::kF32) {
    cost_volume_bwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)f1, (const float*)f2, (const float*)g, (float*)df1,
        (float*)df2, C, H, W);
  } else if (dtype == ocf::kBF16) {
    cost_volume_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)df1, (__nv_bfloat16*)df2,
        C, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
