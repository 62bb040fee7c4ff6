// Tiled GEMM probe, int8 -> int32 and bf16 -> fp32, for Hopper (sm_90a).
//
// Replaces the TPU probe tools/spike_int8.py `make_pallas` (a Pallas GEMM
// with full-K blocks that measured the TPU's int8 and bf16 matrix-unit
// rates): C[M, N] = A[M, K] . B[K, N], all row-major. It measures what a
// plain hand-written tensor-core GEMM reaches on this card, the yardstick
// for the W8A8 conv kernel (conv_group_q8.cu), beside the library GEMMs.
//
// One block computes a 128 x 128 tile of C with eight warps (2 x 4, 64 x 32
// each) on WMMA 16x16x16 (s8 -> s32 or bf16 -> f32), 32 K per step. Shared
// memory keeps every 16x16 operand tile as one contiguous piece (A tiles
// row-major, B tiles row-major), so global rows load as 16-byte vectors and
// each WMMA load reads an aligned tile; the next step's vectors are loaded
// into registers while the tensor cores work. Bound at 2048^3: operations
// (int8 17.2 GOP at 1979 TOP/s = 8.7 us; bf16 at 989 TFLOP/s = 17.4 us).
// No wgmma, TMA or multi-stage pipeline: this is the simple form.

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128, TN = 128, TK = 32;
constexpr int WARPS_N = 4;
constexpr int FM = 4, FN = 2;  // 16x16 fragments per warp: 64 x 32

template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            Acc* __restrict__ Cm, int M, int N, int K) {
  using namespace nvcuda;
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int AV = TM * TK / VEC / THREADS;    // A vectors per thread
  constexpr int BV = TK * TN / VEC / THREADS;    // B vectors per thread
  // [slab kf][tile][16][16]: A tiles over M, B tiles over N
  __shared__ __align__(256) T As[2 * TM * 16];
  __shared__ __align__(256) T Bs[2 * TN * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  uint4 ra[AV], rb[BV];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int e = tid + i * THREADS;
      const int m = e / (TK / VEC), kk = (e % (TK / VEC)) * VEC;
      ra[i] = *reinterpret_cast<const uint4*>(A + (long long)(m0 + m) * K + k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (TN / VEC), n = (e % (TN / VEC)) * VEC;
      rb[i] = *reinterpret_cast<const uint4*>(B + (long long)(k0 + k) * N + n0 + n);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int e = tid + i * THREADS;
      const int m = e / (TK / VEC), kk = (e % (TK / VEC)) * VEC;
      *reinterpret_cast<uint4*>(&As[(kk / 16) * TM * 16 + m * 16 + kk % 16]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (TN / VEC), n = (e % (TN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(
          &Bs[(k / 16) * TN * 16 + (n / 16) * 256 + (k % 16) * 16 + n % 16]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

  load(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    store();
    __syncthreads();
    if (k0 + TK < K) load(k0 + TK);
#pragma unroll
    for (int kf = 0; kf < 2; ++kf) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[kf * TM * 16 + (wm * FM + i) * 256], 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kf * TN * 16 + (wn * FN + j) * 256], 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          Cm + (long long)(m0 + (wm * FM + i) * 16) * N + n0 + (wn * FN + j) * 16,
          acc[i][j], N, wmma::mem_row_major);
}

}  // namespace

// C = A . B, row-major; dtype 0: int8 A, B -> int32 C; 1: bf16 -> fp32.
// M and N multiples of 128, K a multiple of 32.
// Returns cudaGetLastError() after the launch.
extern "C" int ocf_gemm(int dtype, const void* a, const void* b, void* c, int M,
                        int N, int K, void* stream) {
  if (M < TM || N < TN || K < TK || M % TM || N % TN || K % TK)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / TN, M / TM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    gemm_kernel<signed char, int><<<grid, THREADS, 0, s>>>(
        static_cast<const signed char*>(a), static_cast<const signed char*>(b),
        static_cast<int*>(c), M, N, K);
  else if (dtype == 1)
    gemm_kernel<__nv_bfloat16, float><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(c), M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
