// Shared helpers of the cost-volume kernels (cost_volume.cu,
// cost_volume_bwd.cu): staging NCHW rows into shared memory as fp32, and
// vector loads and stores of a thread's P adjacent columns.
#pragma once

#include <cstring>

#include "common.cuh"

namespace ocf {

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned; };
template <> struct VecOf<2> { using type = unsigned short; };

// P consecutive shared-memory floats (16-byte aligned for P = 4).
template <int P>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (P == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e) v[e] = p[e];
  }
}

// v[0..n) * scale stored at p[0..n) in T; one vector store when all P land
// (`whole`: n == P and p aligned to P elements).
template <typename T, int P>
__device__ __forceinline__ void store_cols(T* p, const float* v, float scale, int n,
                                           bool whole) {
  T t[P];
#pragma unroll
  for (int e = 0; e < P; ++e) t[e] = from_f32<T>(v[e] * scale);
  if (whole) {
    typename VecOf<P * sizeof(T)>::type q;
    memcpy(&q, t, sizeof(q));
    *reinterpret_cast<decltype(q)*>(p) = q;
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (e < n) p[e] = t[e];
  }
}

// v[0..n) / div, as store_cols (the forward's mean over channels).
template <typename T, int P>
__device__ __forceinline__ void store_mean(T* p, const float* v, float div, int n,
                                           bool whole) {
  float q[P];
#pragma unroll
  for (int e = 0; e < P; ++e) q[e] = v[e] / div;
  store_cols<T, P>(p, q, 1.f, n, whole);
}

// Stage NCH channels x NROWS rows x WIN columns of an NCHW map into shared
// memory as fp32, with the block's NT threads:
//   dst[ch * ch_stride + row * WIN + u] = src[ch * hw + (y0 + row) * W + xs + u],
//   xs = x0 + ch * xstep,
// zero where ch >= nch or the row or column lies outside the image. With
// `vec` (W a multiple of 16 bytes, src 16-byte aligned) each thread reads
// 16-byte vectors and keeps the elements that fall in the window, BATCH
// vectors in flight before it stores any (one L2 latency per batch, not
// per vector); else one element each. The counts and divisors are
// compile-time constants.
template <typename T, int WIN, int NROWS, int NCH, int NT, int BATCH = 4>
__device__ __forceinline__ void stage_rows(float* dst, int ch_stride, const T* src,
                                           long long hw, int H, int W, int nch, int y0,
                                           int x0, int xstep, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int VE = 16 / sizeof(T);            // elements per vector
    constexpr int NV = (WIN + VE - 1) / VE + 1;   // vectors covering any start
    constexpr int ITEMS = NCH * NROWS * NV;
    constexpr int PER = (ITEMS + NT - 1) / NT;    // vectors per thread
#pragma unroll 1  // rolled: one batch's registers, whatever PER
    for (int k0 = 0; k0 < PER; k0 += BATCH) {
      uint4 raw[BATCH];
      int base[BATCH], off[BATCH];  // dst row + xv - xs, and xv - xs
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = tid + (k0 + k) * NT;
        raw[k] = make_uint4(0, 0, 0, 0);
        off[k] = WIN;  // nothing to store
        if (k0 + k < PER && e < ITEMS) {
          const int slab = e / NV, v = e - slab * NV;
          const int ch = slab / NROWS, row = slab - ch * NROWS;
          const int xs = x0 + ch * xstep;
          const int xv = (xs & -VE) + v * VE;  // floor to a vector, then step
          const int y = y0 + row;
          off[k] = xv - xs;
          base[k] = ch * ch_stride + row * WIN + off[k];
          if (off[k] < WIN && ch < nch && y >= 0 && y < H && xv >= 0 && xv < W)
            raw[k] = *reinterpret_cast<const uint4*>(src + ch * hw + (long long)y * W + xv);
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        T t[VE];
        memcpy(t, &raw[k], sizeof(raw[k]));
#pragma unroll
        for (int q = 0; q < VE; ++q) {
          const int u = off[k] + q;
          if (u >= 0 && u < WIN) dst[base[k] + q] = to_f32(t[q]);
        }
      }
    }
  } else {
    for (int e = tid; e < NCH * NROWS * WIN; e += NT) {
      const int slab = e / WIN, u = e - slab * WIN;
      const int ch = slab / NROWS, row = slab - ch * NROWS;
      const int x = x0 + ch * xstep + u, y = y0 + row;
      const bool in = ch < nch && y >= 0 && y < H && x >= 0 && x < W;
      dst[ch * ch_stride + row * WIN + u] =
          in ? to_f32(src[ch * hw + (long long)y * W + x]) : 0.f;
    }
  }
}

}  // namespace ocf
