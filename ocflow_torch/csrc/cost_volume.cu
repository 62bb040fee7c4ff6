// Cost-volume forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `_forward_pallas` (body `_kernel`): for every pixel, all (2d+1)^2
// correlations  out[b, i*(2d+1)+j, y, x] = mean_c f1[b,c,y,x] *
// f2[b,c,y+i-d,x+j-d]  with f2 zero-padded, accumulated in fp32 and written
// in the input dtype. Layout NCHW in, [B, (2d+1)^2, H, W] out.
//
// Bound on the H100: memory. It reads 2*B*C*H*W and writes 81*B*H*W
// elements against 2*81*C operations per pixel (about 5 flop per byte at
// C=32 in bf16, far under the card's ~295 flop/byte balance point).
//
// Design: one block per (batch, output row, 32-column strip); nine warps,
// warp i owns shift row i, lane = column. Per channel chunk the block
// stages f1's strip and f2's (2d+1)-row x (32+2d)-column window in shared
// memory (zero outside the image), then each thread accumulates its nine
// dx shifts for its column in registers. Every output is written once,
// coalesced along x. The f2 window rows are re-read from L2 by the blocks
// of neighbouring output rows; keeping them on chip across rows is the next
// step towards the bound.

#include "common.cuh"

namespace {

constexpr int D = 4;            // max displacement of the FlowNetCV path
constexpr int N = 2 * D + 1;    // shifts per axis
constexpr int TW = 32;          // output columns per block (one per lane)
constexpr int CC = 16;          // channels staged per chunk

template <typename T>
__global__ void __launch_bounds__(N * 32)
cost_volume_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       T* __restrict__ out, int C, int H, int W) {
  __shared__ float s1[CC][TW];
  __shared__ float s2[CC][N][TW + 2 * D];

  const int x0 = blockIdx.x * TW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int i = threadIdx.x >> 5;  // shift row (dy index)
  const long long hw = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * hw;
  const T* f2b = f2 + (long long)b * C * hw;

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int e = threadIdx.x; e < CC * TW; e += blockDim.x) {
      const int cc = e / TW, xx = e - cc * TW;
      const int c = c0 + cc, x = x0 + xx;
      s1[cc][xx] = (c < C && x < W) ? ocf::to_f32(f1b[c * hw + (long long)y * W + x]) : 0.f;
    }
    constexpr int WIN = TW + 2 * D;
    for (int e = threadIdx.x; e < CC * N * WIN; e += blockDim.x) {
      const int xx = e % WIN;
      const int r = (e / WIN) % N;
      const int cc = e / (WIN * N);
      const int c = c0 + cc, yy = y + r - D, x = x0 + xx - D;
      const bool in = c < C && yy >= 0 && yy < H && x >= 0 && x < W;
      s2[cc][r][xx] = in ? ocf::to_f32(f2b[c * hw + (long long)yy * W + x]) : 0.f;
    }
    __syncthreads();
    const int cn = min(CC, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float a = s1[cc][lane];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = fmaf(a, s2[cc][i][lane + j], acc[j]);
    }
    __syncthreads();
  }

  const int x = x0 + lane;
  if (x < W) {
    const float cf = (float)C;
    T* ob = out + ((long long)b * N * N + i * N) * hw + (long long)y * W + x;
#pragma unroll
    for (int j = 0; j < N; ++j) ob[j * hw] = ocf::from_f32<T>(acc[j] / cf);
  }
}

}  // namespace

// f1, f2: [B, C, H, W] contiguous; out: [B, (2d+1)^2, H, W] contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_fwd(int dtype, const void* f1, const void* f2,
                                   void* out, int B, int C, int H, int W,
                                   int d, void* stream) {
  if (d != D || B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, H, B);
  const dim3 block(N * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ocf::kF32) {
    cost_volume_fwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, C, H, W);
  } else if (dtype == ocf::kBF16) {
    cost_volume_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2,
        (__nv_bfloat16*)out, C, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
