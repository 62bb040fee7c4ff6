// Cost-volume forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `_forward_pallas` (body `_kernel`): for every pixel, all (2d+1)^2
// correlations  out[b, i*(2d+1)+j, y, x] = mean_c f1[b,c,y,x] *
// f2[b,c,y+i-d,x+j-d]  with f2 zero-padded, accumulated in fp32 and written
// in the input dtype. Layout NCHW in, [B, (2d+1)^2, H, W] out. Two
// displacements are compiled: d=4 (81 shifts, FlowNetCV) and d=10 (441
// shifts, the FlowNetC family's 1/8-resolution correlation).
//
// Bound on the H100: at d=4 memory: it reads 2*B*C*H*W and writes 81*B*H*W
// elements against 2*81*C operations per pixel (about 5 flop per byte at
// C=32 in bf16, far under the card's ~295 flop/byte balance point). At d=10
// and C=256 in fp32 the 441 shifts make it 2*441*C operations per pixel
// against about 3.8 KB moved: fp32 operations bound it (59 flop per byte
// against the CUDA cores' 67 TFLOP/s over 3.35 TB/s, 20).
//
// Design: one block per (batch, output row, 32-column strip); 2d+1 warps,
// warp i owns shift row i, lane = column. Per channel chunk the block
// stages f1's strip and f2's (2d+1)-row x (32+2d)-column window in shared
// memory (zero outside the image), then each thread accumulates its 2d+1
// dx shifts for its column in registers. Every output is written once,
// coalesced along x. Each FMA reads one shared-memory float, so the
// shared-memory port bounds it at d=10. The f2 window rows are re-read
// from L2 by the blocks of neighbouring output rows; keeping them on chip
// across rows is the next step towards the bound.
//
// Static shared memory is (CC*32 + CC*(2d+1)*(32+2d)) floats: d=4 with
// CC=16 channels per chunk takes 25,088 B; d=10 takes CC=8, 35,968 B (CC=16
// would need 71,936 B, over the 48 KB static limit). A d=10 block is 672
// threads, so __launch_bounds__ caps registers at 96 a thread.

#include "common.cuh"

namespace {

constexpr int TW = 32;  // output columns per block (one per lane)

template <typename T, int D, int CC>
__global__ void __launch_bounds__((2 * D + 1) * 32)
cost_volume_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       T* __restrict__ out, int C, int H, int W) {
  constexpr int N = 2 * D + 1;  // shifts per axis
  constexpr int WIN = TW + 2 * D;
  __shared__ float s1[CC][TW];
  __shared__ float s2[CC][N][WIN];

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

template <int D, int CC>
int launch(int dtype, const void* f1, const void* f2, void* out, int B, int C,
           int H, int W, cudaStream_t s) {
  const dim3 grid((W + TW - 1) / TW, H, B);
  const dim3 block((2 * D + 1) * 32);
  if (dtype == ocf::kF32) {
    cost_volume_fwd_kernel<float, D, CC><<<grid, block, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, C, H, W);
  } else if (dtype == ocf::kBF16) {
    cost_volume_fwd_kernel<__nv_bfloat16, D, CC><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2,
        (__nv_bfloat16*)out, C, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: [B, C, H, W] contiguous; out: [B, (2d+1)^2, H, W] contiguous;
// d is 4 or 10. Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_fwd(int dtype, const void* f1, const void* f2,
                                   void* out, int B, int C, int H, int W,
                                   int d, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 4) return launch<4, 16>(dtype, f1, f2, out, B, C, H, W, s);
  if (d == 10) return launch<10, 8>(dtype, f1, f2, out, B, C, H, W, s);
  return (int)cudaErrorInvalidValue;
}
