// Cost volume forward and backward at any displacement, for Hopper (sm_90a).
//
// Replaces, for d > 10, the TPU kernel ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `_forward_pallas` (the reference takes its XLA cost volume wherever the
// Pallas block does not fit) and the VJP `_bwd` -> `_bwd_xla_mirror`. The
// tuned kernels (cost_volume.cu, cost_volume_bwd.cu) keep d = 1..10: a thread
// there holds (2d+1) x 4 fp32 sums in registers, which does not scale past
// d = 10. These two kernels are the simple form, one thread per output
// element, correct first:
//
//   forward   out[b, i*n+j, y, x] = sum_c f1[b,c,y,x] * f2[b,c,y+i-d,x+j-d] / C
//   backward  df1[b,c,y,x]   = sum_s g[b,s,y,x] * f2[b,c,y+dy_s,x+dx_s] / C
//             df2[b,c,y',x'] = sum_s g[b,s,y'-dy_s,x'-dx_s] * f1[b,c,y'-dy_s,x'-dx_s] / C
//
// with n = 2d+1, shift s = i*n+j, (dy_s, dx_s) = (i-d, j-d) and every tap
// outside the image zero. The backward is the gather form of the plain
// version (each output element sums its own terms: no atomics, the same
// result on every run); one launch computes df1 and df2, the first half of
// the grid df1, the second df2. Sums in fp32 for fp32 and bf16 inputs, the
// result rounded once into the input dtype. Layout NCHW, cost volume
// [B, n*n, H, W]; consecutive threads own consecutive x, so every load and
// store of a warp is one run of a row (f1 and the cotangent rows are read
// again for each shift or channel, from L2).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cost_volume_any_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           T* __restrict__ out, int C, int H, int W, int d,
                           long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int n = 2 * d + 1;
  const int x = (int)(idx % W);
  long long r = idx / W;
  const int y = (int)(r % H);
  r /= H;
  const int s = (int)(r % (n * n));
  const long long b = r / (n * n);
  const int y2 = y + s / n - d, x2 = x + s % n - d;
  float acc = 0.f;
  if (y2 >= 0 && y2 < H && x2 >= 0 && x2 < W) {
    const long long plane = (long long)H * W;
    const T* p1 = f1 + b * C * plane + (long long)y * W + x;
    const T* p2 = f2 + b * C * plane + (long long)y2 * W + x2;
    for (int c = 0; c < C; ++c)
      acc += ocf::to_f32(p1[c * plane]) * ocf::to_f32(p2[c * plane]);
  }
  out[idx] = ocf::from_f32<T>(acc / (float)C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cost_volume_any_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           const T* __restrict__ g, T* __restrict__ df1,
                           T* __restrict__ df2, int C, int H, int W, int d,
                           long long per) {
  long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= 2 * per) return;
  const bool second = idx >= per;
  if (second) idx -= per;
  const int n = 2 * d + 1;
  const int x = (int)(idx % W);
  long long r = idx / W;
  const int y = (int)(r % H);
  r /= H;
  const int c = (int)(r % C);
  const long long b = r / C;
  const long long plane = (long long)H * W;
  const T* gb = g + b * n * n * plane;
  float acc = 0.f;
  if (!second) {
    // df1: the cotangent at (y, x) times f2 at (y, x) + shift
    const T* f2c = f2 + (b * C + c) * plane;
    for (int i = 0; i < n; ++i) {
      const int yy = y + i - d;
      if (yy < 0 || yy >= H) continue;
      for (int j = 0; j < n; ++j) {
        const int xx = x + j - d;
        if (xx < 0 || xx >= W) continue;
        acc += ocf::to_f32(gb[(long long)(i * n + j) * plane + (long long)y * W + x]) *
               ocf::to_f32(f2c[(long long)yy * W + xx]);
      }
    }
    df1[idx] = ocf::from_f32<T>(acc * (1.0f / (float)C));
  } else {
    // df2: every (pixel, shift) whose shifted tap lands on (y, x)
    const T* f1c = f1 + (b * C + c) * plane;
    for (int i = 0; i < n; ++i) {
      const int yy = y - (i - d);
      if (yy < 0 || yy >= H) continue;
      for (int j = 0; j < n; ++j) {
        const int xx = x - (j - d);
        if (xx < 0 || xx >= W) continue;
        const long long p = (long long)yy * W + xx;
        acc += ocf::to_f32(gb[(long long)(i * n + j) * plane + p]) * ocf::to_f32(f1c[p]);
      }
    }
    df2[idx] = ocf::from_f32<T>(acc * (1.0f / (float)C));
  }
}

unsigned blocks(long long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

}  // namespace

// f1, f2: [B, C, H, W] contiguous; out: [B, (2d+1)^2, H, W] contiguous, one
// dtype; d >= 1. Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_any_fwd(int dtype, const void* f1, const void* f2,
                                       void* out, int B, int C, int H, int W, int d,
                                       void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || d < 1) return (int)cudaErrorInvalidValue;
  const long long n = 2LL * d + 1;
  const long long total = (long long)B * n * n * H * W;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ocf::kF32) {
    cost_volume_any_fwd_kernel<float><<<blocks(total), kThreads, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, C, H, W, d, total);
  } else if (dtype == ocf::kBF16) {
    cost_volume_any_fwd_kernel<__nv_bfloat16><<<blocks(total), kThreads, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (__nv_bfloat16*)out, C, H, W,
        d, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// f1, f2, df1, df2: [B, C, H, W] contiguous; g: [B, (2d+1)^2, H, W]
// contiguous, all of one dtype; d >= 1. Returns cudaGetLastError() after the
// launch.
extern "C" int ocf_cost_volume_any_bwd(int dtype, const void* f1, const void* f2,
                                       const void* g, void* df1, void* df2, int B, int C,
                                       int H, int W, int d, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || d < 1) return (int)cudaErrorInvalidValue;
  const long long per = (long long)B * C * H * W;
  if ((2 * per + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ocf::kF32) {
    cost_volume_any_bwd_kernel<float><<<blocks(2 * per), kThreads, 0, s>>>(
        (const float*)f1, (const float*)f2, (const float*)g, (float*)df1, (float*)df2, C, H,
        W, d, per);
  } else if (dtype == ocf::kBF16) {
    cost_volume_any_bwd_kernel<__nv_bfloat16><<<blocks(2 * per), kThreads, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (const __nv_bfloat16*)g,
        (__nv_bfloat16*)df1, (__nv_bfloat16*)df2, C, H, W, d, per);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
