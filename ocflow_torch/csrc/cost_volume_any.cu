// Cost volume forward and backward at any displacement d > 10, for Hopper
// (sm_90a).
//
// Replaces, for d > 10, the TPU kernel ocflow_tpu/ops/pallas/cost_volume_kernel.py
// `_forward_pallas` (the reference takes its XLA cost volume wherever the
// Pallas block does not fit) and the VJP `_bwd` -> `_bwd_xla_mirror`:
//
//   forward   out[b, i*n+j, y, x] = sum_c f1[b,c,y,x] * f2[b,c,y+i-d,x+j-d] / C
//   backward  df1[b,c,y,x]   = sum_s g[b,s,y,x] * f2[b,c,y+dy_s,x+dx_s] / C
//             df2[b,c,y',x'] = sum_s g[b,s,y'-dy_s,x'-dx_s] * f1[b,c,y'-dy_s,x'-dx_s] / C
//
// with n = 2d+1, shift s = i*n+j, (dy_s, dx_s) = (i-d, j-d) and every tap
// outside the image zero; fp32 sums for fp32 and bf16 inputs, one rounding
// into the input dtype; no atomics, so every run gives the same result.
// Layout NCHW, cost volume [B, n*n, H, W]. The tuned kernels
// (cost_volume.cu, cost_volume_bwd.cu) keep d = 1..10: a thread there holds
// (2d+1) x 4 values in registers. Here d is a runtime argument, and
// registers and shared memory do not grow with it (the backward's ring
// excepted, which is bounded): one compiled kernel of each kind serves
// every d > 10.
//
// Bound on the H100. fp32 operations: 2*n^2*C per pixel forward, 4*n^2*C
// per (channel, pixel) backward, against ~(2C + n^2) and ~(4C + n^2)
// elements moved; at d=12, C=256 ~160 flop per byte, far above the CUDA
// cores' 67 TFLOP/s over 3.35 TB/s (20): 0.274 ms forward and 0.548 ms
// backward at 8x256x56x128 (a FlowNetC built with displacement 12). Per
// FMA a thread reads about a tenth of a float4 from shared memory, so its
// 128 bytes a clock per SM bind before the FMAs do.
//
// Staged tiles are aligned. Every tile starts at a column that is a
// multiple of 4 (the window's own start e = 0..3 columns later), so each
// 4-element vector lies whole inside or outside the image (W a multiple of
// 4) and lands on a 16-byte boundary: fp32 tiles are copied by `cp.async`
// straight into their buffer (zero-filled outside the image), bf16 tiles
// into per-thread slots and widened to fp32 by the thread that copied them.
// A thread's FMAs read its window as float4s from the aligned column and
// index it at e + ...; e is the same for the whole block, so the body is
// compiled for each e and picked once. W not a multiple of 4 (or an
// unaligned base) takes an element path, staged after the FMAs.
//
// Forward design. A block owns a band of R output rows, a 32-column strip,
// IS shift rows i0.. and JS shift columns j0.. (the grid's x runs over the
// shift groups fastest, then the strips: the blocks that read one tile run
// together). Per chunk of CC channels it stages f1's R x 32 tile and f2's
// (R+IS-1) rows x (32+JS+2, rounded up to float4s) columns from (y0+i0-d,
// x0+j0-d-e). A thread owns P adjacent columns of one (row, shift row): per
// channel it reads its P f1 values and its P+JS-1 window of f2 and does
// JS*P FMAs on registers (acc[JS][P]). Where IS or JS does not divide n,
// the last group's surplus shifts are computed and not stored.
//
// Backward design (gather form, cost_volume_bwd.cu's structure). A block
// owns R rows x 32 columns x CB channels of one image and computes df1 or
// df2 there (the grid's z: image x {df1, df2}; channel groups fastest). It
// streams over the n shift rows i (downwards for df2); the feature rows (f2
// for df1, f1 for df2) stay on chip in a ring of R+1 rows per channel, one
// new row per step. Inside a step it walks the shift columns in groups of
// JS (a "unit"): it stages the unit's JS cotangent channels, and a thread
// holding P columns of CH channels of one row does, per channel, JS*P FMAs
// from a P+JS-1 window of the ring row at the group's first column:
//   df1: acc[c][x] += g[i*n+j][y][x]               * F[c][x + j]
//   df2: acc[c][x] += g[i*n+n-1-j'][y+d-i][x-d+j'] * F[c][x + j']
// with F's ring row y+i-d (df1) or y-i+d (df2) from column x-d. For df2
// the cotangent's channel j' is staged unshifted, from column x0-d+j'0-e,
// and each thread reads its 4 columns of channel j' at offset j'-j'0+e.
// The ring is 36 + SPAN*JS columns wide for SPAN groups of shift columns,
// dynamic shared memory; where all ceil(n/JS) groups would pass the SM's
// 227 KB, the block walks the shift columns in passes of SPAN groups, each
// a full sweep over i with its own ring (no limit on d). Surplus columns of
// the last group read a zero cotangent.
//
// Staging overlaps the FMAs. While a chunk (forward) or unit (backward) is
// computed, the next one is on its way by `cp.async` into the other of two
// buffers (the backward's ring: a slice of the next step's new row with
// each unit); then one barrier. Loads held in registers and stored after
// the FMAs instead were slower in fp32, where the copy needs no widening
// (PERF.md). CV_ANY_SKIP, for the ablation only, drops the FMAs (1)
// or the staging after the first chunk or unit (2).
//
// Measured on an H100 SXM (700 W; `python -m
// ocflow_torch.tools.cost_volume_ablation`, PERF.md has every case): at
// d=12, 8x256x56x128 fp32, forward 0.757 ms (36% of bound; 8.19 with one
// thread an output before), backward 2.37 ms (23%; 14.98). The staging
// alone takes 0.40 / 1.17 ms there and the FMAs alone 0.64 / 1.70: they
// overlap only in part. ptxas: forward 128 registers (the cap for 3 blocks
// of 160 threads), 720 B spilled in fp32; backward 255, 52 B (one block of
// 256 threads, a ring of 9 x 64 rows). At d=10 these kernels beat the tuned
// ones (0.76 / 1.54 ms against 0.82 / 1.98); the wrapper keeps d <= 10 on
// those.
//
// Tensor cores are not used: for fp32 inputs a TF32 or bf16 product would
// be another result than the JAX package serves.

#include <cstdint>

#include "cv_stage.cuh"

namespace {

constexpr int TW = 32;            // output columns per block
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100 (227 KB)

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Forward configuration: R, IS, JS, CC, P, MINB (rows per band, shift rows
// per block, shift columns per block, channels per chunk, columns per
// thread, min blocks per SM).
#define CV_ANY_FWD 4, 5, 13, 8, 4, 3
// Backward configuration: R, CB, CH, JS, P, MINB (rows per band, channels
// per block, channels per thread, shift columns per unit (a multiple of 4),
// columns per thread, min blocks per SM).
#define CV_ANY_BWD 8, 64, 16, 12, 4, 1
#define CV_ANY_SKIP 0
constexpr int kSkip = CV_ANY_SKIP;

// 4 elements, the unit of staging: 16 bytes of fp32, 8 of bf16
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = uint4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ float4 widen(typename Vec4<T>::type raw) {
  T v[4];
  memcpy(v, &raw, sizeof(raw));
  return make_float4(ocf::to_f32(v[0]), ocf::to_f32(v[1]), ocf::to_f32(v[2]),
                     ocf::to_f32(v[3]));
}

// 4 elements from global to shared memory, zero-filled where !in
template <typename T>
__device__ __forceinline__ void cp_async4(void* smem, const T* gmem, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(in ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tile to stage into shared memory as fp32:
//   dst[ch * dch + row * drow + u] = src[ch * sch + (y0 + row) * W + xa + u]
// for ch < cap, row < nrows, u < win (a multiple of 4; xa too on the vector
// path); zero where ch >= nch or the tap lies outside the image.
template <typename T>
struct Tile {
  const T* src;
  long long sch;
  int cap, nch, nrows, win, y0, xa;
  float* dst;
  int dch, drow;
};

// vector e of the tile: channel, row, first column u, and whether it lies
// in the image
template <typename T>
struct Item {
  int ch, row, u;
  bool in;
  const T* ptr;
  __device__ __forceinline__ Item(const Tile<T>& t, int e, int H, int W) {
    const int nv = t.win / 4, slab = e / nv;
    u = (e - slab * nv) * 4;
    row = slab % t.nrows;
    ch = slab / t.nrows;
    const int x = t.xa + u, y = t.y0 + row;
    in = ch < t.nch && y >= 0 && y < H && x >= 0 && x < W;
    ptr = in ? t.src + ch * t.sch + (long long)y * W + x : t.src;
  }
  __device__ __forceinline__ float* at(const Tile<T>& t) const {
    return t.dst + ch * t.dch + row * t.drow + u;
  }
};

template <typename T>
__device__ __forceinline__ int items(const Tile<T>& t) {
  return t.win > 0 ? t.cap * t.nrows * (t.win / 4) : 0;
}

// the element path (W not a multiple of 4, or an unaligned base)
template <typename T, int NT>
__device__ __forceinline__ void stage_elements(const Tile<T>& t, int H, int W) {
  const int n = t.cap * t.nrows * max(t.win, 0);
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += NT) {
    const int slab = e / t.win, u = e - slab * t.win;
    const int row = slab % t.nrows, ch = slab / t.nrows;
    const int x = t.xa + u, y = t.y0 + row;
    const bool in = ch < t.nch && y >= 0 && y < H && x >= 0 && x < W;
    t.dst[ch * t.dch + row * t.drow + u] =
        in ? ocf::to_f32(t.src[ch * t.sch + (long long)y * W + x]) : 0.f;
  }
}

// cp.async: fp32 vectors straight into place, bf16 ones into this thread's
// slots (slots[e] for its items e), widened after cp_async_wait_all() by
// the same thread, so no barrier between
template <typename T, int NT>
__device__ __forceinline__ void issue_async(const Tile<T>& t, typename Vec4<T>::type* slots,
                                            int H, int W, bool vec) {
  if (!vec) return;
  const int n = items(t);
  for (int e = threadIdx.x; e < n; e += NT) {
    const Item<T> it(t, e, H, W);
    if constexpr (sizeof(T) == 4) cp_async4(it.at(t), it.ptr, it.in);
    else cp_async4(slots + e, it.ptr, it.in);
  }
}

template <typename T, int NT>
__device__ __forceinline__ void finish_async(const Tile<T>& t,
                                             const typename Vec4<T>::type* slots, int H, int W,
                                             bool vec) {
  if (!vec) return stage_elements<T, NT>(t, H, W);
  if constexpr (sizeof(T) == 2) {
    const int n = items(t);
    for (int e = threadIdx.x; e < n; e += NT) {
      const Item<T> it(t, e, H, W);
      *reinterpret_cast<float4*>(it.at(t)) = widen<T>(slots[e]);
    }
  }
}

// bytes of cp.async slots for `n` vectors (bf16 only)
template <typename T>
__host__ __device__ constexpr long long slot_bytes(long long n) {
  return sizeof(T) == 2 ? 8 * n : 0;
}

// ---------------------------------------------------------------- forward

template <typename T, int R, int IS, int JS, int CC, int P>
struct FwdShape {
  static constexpr int CG = TW / P;                  // column groups per row
  static constexpr int NT = R * IS * CG;             // threads
  static constexpr int WIN = round4(TW + JS + 2);    // staged f2 columns, any e
  static constexpr int R2 = R + IS - 1;              // staged f2 rows
  static constexpr int CS = R * TW + R2 * WIN;       // floats of a channel's two tiles
  static constexpr int V1 = TW / 4, V2 = WIN / 4;    // vectors of a tile row
  static constexpr int POS = R * V1 + R2 * V2;       // vectors of a channel's two tiles
  static constexpr int PPT = (POS + NT - 1) / NT;    // of them a thread's
};

// shared memory of the forward (bytes): two buffers [CC][f1 tile, f2 tile],
// the cp.async slots of bf16
template <typename T, int R, int IS, int JS, int CC, int P>
constexpr int fwd_smem() {
  using S = FwdShape<T, R, IS, JS, CC, P>;
  return 4 * 2 * CC * S::CS + (int)slot_bytes<T>(S::PPT * CC * S::NT);
}

// The forward's staging. Every chunk's tiles have the same geometry, so a
// thread takes the same vector positions of each (f1 or f2, row, column)
// in every channel: their offsets are computed once per block, and a chunk
// costs a thread CC copies per position.
template <typename T, int R, int IS, int JS, int CC, int P>
struct FwdStager {
  using S = FwdShape<T, R, IS, JS, CC, P>;
  using V = typename Vec4<T>::type;
  int goff[S::PPT];  // offset in a channel plane, -1 outside the image
  int soff[S::PPT];  // offset in a channel's tiles, -1 for no position

  __device__ __forceinline__ FwdStager(int H, int W, int y0, int x0, int y2, int x2) {
#pragma unroll
    for (int k = 0; k < S::PPT; ++k) {
      const int p = threadIdx.x + k * S::NT;
      const bool two = p >= R * S::V1;  // a vector of f2's tile
      const int q = two ? p - R * S::V1 : p, nv = two ? S::V2 : S::V1;
      const int row = q / nv, x = (two ? x2 : x0) + (q - row * nv) * 4;
      const int y = (two ? y2 : y0) + row;
      soff[k] = p < S::POS ? (two ? R * TW + row * S::WIN : row * TW) + x - (two ? x2 : x0)
                           : -1;
      goff[k] = y >= 0 && y < H && x >= 0 && x < W ? y * W + x : -1;
    }
  }
  __device__ __forceinline__ const T* src(int k, const T* f1c, const T* f2c) const {
    return (soff[k] >= R * TW ? f2c : f1c) + max(goff[k], 0);
  }
  // copies of chunk (f1c, f2c: its first channel's planes) into dst
  __device__ __forceinline__ void issue(const T* f1c, const T* f2c, long long hw, int nch,
                                        float* dst, V* slots) {
#pragma unroll
    for (int k = 0; k < S::PPT; ++k) {
      if (soff[k] < 0) continue;
      const T* s = src(k, f1c, f2c);
#pragma unroll
      for (int ch = 0; ch < CC; ++ch) {
        const bool in = goff[k] >= 0 && ch < nch;
        if constexpr (sizeof(T) == 4)
          cp_async4(dst + ch * S::CS + soff[k], in ? s + ch * hw : s, in);
        else
          cp_async4(slots + (k * CC + ch) * S::NT + threadIdx.x, in ? s + ch * hw : s, in);
      }
    }
  }
  // after cp_async_wait_all(): widen what is not yet in place
  __device__ __forceinline__ void finish(float* dst, const V* slots) {
    if constexpr (sizeof(T) == 4) return;
#pragma unroll
    for (int k = 0; k < S::PPT; ++k) {
      if (soff[k] < 0) continue;
#pragma unroll
      for (int ch = 0; ch < CC; ++ch)
        *reinterpret_cast<float4*>(dst + ch * S::CS + soff[k]) =
            widen<T>(slots[(k * CC + ch) * S::NT + threadIdx.x]);
    }
  }
};

template <typename T, int R, int IS, int JS, int CC, int P, int E>
__device__ __forceinline__ void fwd_body(const T* __restrict__ f1, const T* __restrict__ f2,
                                         T* __restrict__ out, float* smem, int C, int H, int W,
                                         int d, int b, int x0, int y0, int i0, int j0,
                                         bool vec) {
  using S = FwdShape<T, R, IS, JS, CC, P>;
  using V = typename Vec4<T>::type;
  constexpr int NW = round4(P + JS - 1 + E);  // a thread's f2 window, from its aligned column
  float* buf[2] = {smem, smem + CC * S::CS};
  V* slots = reinterpret_cast<V*>(smem + 2 * CC * S::CS);
  const int n = 2 * d + 1;
  const int cg = threadIdx.x % S::CG;
  const int q = threadIdx.x / S::CG;
  const int ii = q % IS, r = q / IS;
  const long long hw = (long long)H * W;
  const int y2 = y0 + i0 - d, x2 = x0 + j0 - d - E;  // f2's tile
  const T* f1b = f1 + (long long)b * C * hw;
  const T* f2b = f2 + (long long)b * C * hw;

  FwdStager<T, R, IS, JS, CC, P> stager(H, W, y0, x0, y2, x2);
  auto issue = [&](int k) {  // chunk k into buffer k & 1
    const int c0 = k * CC, nch = min(CC, C - c0);
    if (vec) stager.issue(f1b + c0 * hw, f2b + c0 * hw, hw, nch, buf[k & 1], slots);
  };
  auto finish = [&](int k) {
    const int c0 = k * CC, nch = min(CC, C - c0);
    if (vec) return stager.finish(buf[k & 1], slots);
    const Tile<T> t1{f1b + c0 * hw, hw, CC, nch, R, TW, y0, x0, buf[k & 1], S::CS, TW};
    const Tile<T> t2{f2b + c0 * hw, hw, CC, nch, S::R2, S::WIN, y2, x2, buf[k & 1] + R * TW,
                     S::CS, S::WIN};
    stage_elements<T, S::NT>(t1, H, W);
    stage_elements<T, S::NT>(t2, H, W);
  };

  float acc[JS][P];
#pragma unroll
  for (int j = 0; j < JS; ++j)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[j][p] = 0.f;

  const int nchunks = (C + CC - 1) / CC;
  issue(0);
  cp_async_wait_all();
  finish(0);
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const bool more = k + 1 < nchunks && kSkip != 2;
    if (more) issue(k + 1);
    if (kSkip != 1) {
      const float* a_row = buf[k & 1] + r * TW + cg * P;
      const float* w_row = buf[k & 1] + R * TW + (r + ii) * S::WIN + cg * P;
#pragma unroll 2
      for (int cc = 0; cc < CC; ++cc) {
        float a[P], w[NW];
#pragma unroll
        for (int v = 0; v < P; v += 4) ocf::lds<4>(a_row + cc * S::CS + v, a + v);
#pragma unroll
        for (int v = 0; v < NW; v += 4) ocf::lds<4>(w_row + cc * S::CS + v, w + v);
#pragma unroll
        for (int j = 0; j < JS; ++j)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[j][p] = fmaf(a[p], w[E + p + j], acc[j][p]);
      }
    }
    if (more) {
      cp_async_wait_all();
      finish(k + 1);
    }
    __syncthreads();
  }

  const int y = y0 + r, x = x0 + cg * P, i = i0 + ii;
  if (y < H && x < W && i < n) {
    const float cf = (float)C;
    T* ob = out + ((long long)b * n * n + (long long)i * n + j0) * hw + (long long)y * W + x;
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      if (j0 + j >= n) break;
#pragma unroll
      for (int v = 0; v < P; v += 4) {
        const int m = min(4, W - x - v);
        if (m > 0)
          ocf::store_mean<T, 4>(ob + j * hw + v, acc[j] + v, cf, m, m == 4 && W % 4 == 0);
      }
    }
  }
}

template <typename T, int R, int IS, int JS, int CC, int P, int MINB>
__global__ void __launch_bounds__(FwdShape<T, R, IS, JS, CC, P>::NT, MINB)
cost_volume_any_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           T* __restrict__ out, int C, int H, int W, int d, int igroups,
                           int jgroups, bool vec) {
  static_assert(P % 4 == 0 && TW % P == 0, "layout");
  extern __shared__ __align__(16) float smem[];
  int z = blockIdx.x;
  const int jg = z % jgroups;
  z /= jgroups;
  const int ig = z % igroups;
  const int x0 = z / igroups * TW, y0 = blockIdx.y * R, b = blockIdx.z;
  const int i0 = ig * IS, j0 = jg * JS;
  // the f2 window starts at x0 + j0 - d, e = its offset from a multiple of 4
  switch ((j0 - d) & 3) {
#define CV_ANY_FWD_E(e)                                                                     \
  case e:                                                                                    \
    return fwd_body<T, R, IS, JS, CC, P, e>(f1, f2, out, smem, C, H, W, d, b, x0, y0, i0,    \
                                            j0, vec);
    CV_ANY_FWD_E(0) CV_ANY_FWD_E(1) CV_ANY_FWD_E(2) CV_ANY_FWD_E(3)
#undef CV_ANY_FWD_E
  }
}

template <typename T, int R, int IS, int JS, int CC, int P, int MINB>
int launch_fwd_t(const void* f1, const void* f2, void* out, int B, int C, int H, int W, int d,
                 cudaStream_t s) {
  const int n = 2 * d + 1;
  const int ig = (n + IS - 1) / IS, jg = (n + JS - 1) / JS;
  const long long gx = (long long)((W + TW - 1) / TW) * ig * jg;
  if (gx > 0x7fffffffLL || (H + R - 1) / R > 65535 || B > 65535 ||
      (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem<T, R, IS, JS, CC, P>();
  auto kernel = cost_volume_any_fwd_kernel<T, R, IS, JS, CC, P, MINB>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = W % 4 == 0 && ((uintptr_t)f1 | (uintptr_t)f2) % 16 == 0;
  kernel<<<dim3((unsigned)gx, (H + R - 1) / R, B), FwdShape<T, R, IS, JS, CC, P>::NT, smem,
           s>>>((const T*)f1, (const T*)f2, (T*)out, C, H, W, d, ig, jg, vec);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- backward

template <typename T, int R, int CB, int CH, int JS, int P>
struct BwdShape {
  static constexpr int CG = TW / P, NS = CB / CH;
  static constexpr int NT = CG * R * NS;          // threads
  static constexpr int GW = TW + 4 + JS;          // staged cotangent columns (df2; df1 32)
  static constexpr int SG = JS * R * GW;          // floats of one unit's cotangent
  static constexpr int IG = SG / 4;               // its vectors
};

// Shared memory of the backward (bytes) for `span` groups of shift columns
// a pass: the ring [CB][R+1][rw] (rw = 36 + span*JS), two cotangent
// buffers, the cp.async slots (bf16: the cotangent's and a ring row's).
template <typename T, int R, int CB, int CH, int JS, int P>
__host__ __device__ constexpr long long bwd_smem(int span) {
  using S = BwdShape<T, R, CB, CH, JS, P>;
  const int rw = TW + 4 + span * JS;
  return 4LL * CB * (R + 1) * rw + 4LL * 2 * S::SG +
         slot_bytes<T>(S::IG + CB * rw / 4);
}

template <typename T, int R, int CB, int CH, int JS, int P, bool DF2, int E>
__device__ __forceinline__ void bwd_body(const T* __restrict__ feat, const T* __restrict__ g,
                                         T* __restrict__ dout, float* smem, int b, int c0,
                                         int x0, int y0, int C, int H, int W, int d, int span,
                                         bool vec) {
  using S = BwdShape<T, R, CB, CH, JS, P>;
  using V = typename Vec4<T>::type;
  constexpr int NW = round4(P + JS - 1 + E);  // a thread's ring window, from its aligned column
  constexpr int GW = DF2 ? S::GW : TW;        // cotangent row stride
  const int n = 2 * d + 1, nj = (n + JS - 1) / JS;
  const int rw = TW + 4 + span * JS;
  float* ring = smem;                                 // [CB][R+1][rw]
  float* sg = ring + CB * (R + 1) * rw;               // [2][JS][R][GW]
  V* slots = reinterpret_cast<V*>(sg + 2 * S::SG);
  V* ring_slots = slots + S::IG;
  const int cg = threadIdx.x % S::CG;
  const int s = (threadIdx.x / S::CG) % S::NS;
  const int r = threadIdx.x / (S::CG * S::NS);
  const long long hw = (long long)H * W;
  const T* gb = g + (long long)b * n * n * hw;

  // cotangent of unit (st, jg), shift columns j' = jg*JS + jj:
  //   df1: G[jj][r][t] = g[i*n + j', y0+r, x0+t]
  //   df2: G[jj][r][t] = g[i*n + n-1-j', y0+r+d-i, x0-d+jg*JS-E+t]
  Tile<T> tg{gb, DF2 ? -hw : hw, JS, 0, R, GW, y0, DF2 ? 0 : x0, nullptr, R * GW, GW};
  auto unit = [&](int st, int jg, int buf) {
    const int i = DF2 ? n - 1 - st : st, jp = jg * JS;
    tg.nch = min(JS, n - jp);
    tg.dst = sg + buf * S::SG;
    tg.src = gb + ((long long)i * n + (DF2 ? n - 1 - jp : jp)) * hw;
    if (DF2) {
      tg.y0 = y0 + d - i;
      tg.xa = x0 - d + jp - E;
    }
  };
  // feature row q (image row y0 - d + q) in ring slot q % (R+1); columns
  // [u0, u1) of the pass's window from x0 - d + g0*JS - E
  Tile<T> tr{feat + ((long long)b * C + c0) * hw, hw, CB, min(CB, C - c0), 1, 0, 0, 0,
             nullptr, (R + 1) * rw, rw};
  auto ring_row = [&](int q, int g0, int u0, int u1) {
    tr.y0 = y0 - d + q;
    tr.xa = x0 - d + g0 * JS - E + u0;
    tr.win = u1 - u0;
    tr.dst = ring + (q % (R + 1)) * rw + u0;
  };

  float acc[CH][P];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[ch][p] = 0.f;

  for (int g0 = 0; g0 < nj; g0 += span) {
    const int g1 = min(nj, g0 + span), ns = g1 - g0;
    const int sw = round4((rw + ns - 1) / ns);  // a unit's slice of the next ring row
    for (int q = 0; q < R; ++q) {
      ring_row(q, g0, 0, rw);
      issue_async<T, S::NT>(tr, ring_slots, H, W, vec);
      cp_async_wait_all();
      finish_async<T, S::NT>(tr, ring_slots, H, W, vec);
    }
    unit(0, g0, 0);
    issue_async<T, S::NT>(tg, slots, H, W, vec);
    cp_async_wait_all();
    finish_async<T, S::NT>(tg, slots, H, W, vec);
    __syncthreads();
    int u = 0;
    for (int st = 0; st < n; ++st) {
      for (int jg = g0; jg < g1; ++jg, ++u) {
        const bool last = jg + 1 == g1;
        const int nst = last ? st + 1 : st;
        const bool next = nst < n && kSkip != 2, slice = st + 1 < n && kSkip != 2;
        if (next) {
          unit(nst, last ? g0 : jg + 1, (u + 1) & 1);
          issue_async<T, S::NT>(tg, slots, H, W, vec);
        }
        if (slice) {  // the next step's new row, slice jg - g0 of ns
          const int k = jg - g0;
          ring_row(st + R, g0, min(k * sw, rw), min((k + 1) * sw, rw));
          issue_async<T, S::NT>(tr, ring_slots, H, W, vec);
        }

        if (kSkip != 1) {
          float gv[JS][P];
          const float* gbuf = sg + (u & 1) * S::SG + r * GW + cg * P;
#pragma unroll
          for (int j = 0; j < JS; ++j) {
            if (DF2) {  // columns j + E .. j + E + 3 of an aligned pair of float4s
              float t8[8];
              const int lo = (j + E) & ~3, sh = (j + E) & 3;
              ocf::lds<4>(gbuf + j * R * GW + lo, t8);
              if (sh) ocf::lds<4>(gbuf + j * R * GW + lo + 4, t8 + 4);
#pragma unroll
              for (int p = 0; p < P; ++p) gv[j][p] = t8[sh + p];
            } else {
              ocf::lds<P>(gbuf + j * R * GW, gv[j]);
            }
          }
          const float* frow = ring + ((st + r) % (R + 1)) * rw + cg * P + (jg - g0) * JS;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            float w[NW];
#pragma unroll
            for (int v = 0; v < NW; v += 4)
              ocf::lds<4>(frow + (s * CH + ch) * (R + 1) * rw + v, w + v);
#pragma unroll
            for (int j = 0; j < JS; ++j)
#pragma unroll
              for (int p = 0; p < P; ++p)
                acc[ch][p] = fmaf(gv[j][p], w[E + p + j], acc[ch][p]);
          }
        }

        cp_async_wait_all();
        if (next) finish_async<T, S::NT>(tg, slots, H, W, vec);
        if (slice) finish_async<T, S::NT>(tr, ring_slots, H, W, vec);
        __syncthreads();
      }
    }
  }

  const int y = y0 + r, x = x0 + cg * P;
  if (y < H && x < W) {
    const float inv_c = 1.f / (float)C;
    const int m = min(P, W - x);
    const bool whole = m == P && W % P == 0;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = c0 + s * CH + ch;
      if (c < C)
        ocf::store_cols<T, P>(dout + ((long long)b * C + c) * hw + (long long)y * W + x,
                              acc[ch], inv_c, m, whole);
    }
  }
}

template <typename T, int R, int CB, int CH, int JS, int P, int MINB>
__global__ void __launch_bounds__(BwdShape<T, R, CB, CH, JS, P>::NT, MINB)
cost_volume_any_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           const T* __restrict__ g, T* __restrict__ df1, T* __restrict__ df2,
                           int C, int H, int W, int d, int strips, int span, bool vec) {
  static_assert(JS % 4 == 0 && P == 4 && CB % CH == 0, "layout");
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.x * CB;
  const int x0 = (blockIdx.y % strips) * TW;
  const int y0 = (blockIdx.y / strips) * R;
  const int b = blockIdx.z >> 1;
  // the ring rows start at x0 - d + (a multiple of JS): e = (-d) & 3
  switch (((blockIdx.z & 1) << 2) | ((-d) & 3)) {
#define CV_ANY_BWD_E(e)                                                                       \
  case e:                                                                                     \
    return bwd_body<T, R, CB, CH, JS, P, false, e>(f2, g, df1, smem, b, c0, x0, y0, C, H, W, \
                                                   d, span, vec);                            \
  case 4 + e:                                                                                 \
    return bwd_body<T, R, CB, CH, JS, P, true, e>(f1, g, df2, smem, b, c0, x0, y0, C, H, W, d, \
                                                  span, vec);
    CV_ANY_BWD_E(0) CV_ANY_BWD_E(1) CV_ANY_BWD_E(2) CV_ANY_BWD_E(3)
#undef CV_ANY_BWD_E
  }
}

template <typename T, int R, int CB, int CH, int JS, int P, int MINB>
int launch_bwd_t(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
                 int C, int H, int W, int d, cudaStream_t s) {
  const int n = 2 * d + 1, nj = (n + JS - 1) / JS;
  int span = nj;  // all groups of shift columns in one pass where they fit
  while (span > 1 && bwd_smem<T, R, CB, CH, JS, P>(span) > kMaxSmem) --span;
  const long long smem = bwd_smem<T, R, CB, CH, JS, P>(span);
  const int strips = (W + TW - 1) / TW;
  const long long tiles = (long long)strips * ((H + R - 1) / R);
  if (smem > kMaxSmem || tiles > 65535 || 2LL * B > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = cost_volume_any_bwd_kernel<T, R, CB, CH, JS, P, MINB>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = W % 4 == 0 && ((uintptr_t)f1 | (uintptr_t)f2 | (uintptr_t)g) % 16 == 0;
  const dim3 grid((C + CB - 1) / CB, (unsigned)tiles, 2 * B);
  kernel<<<grid, BwdShape<T, R, CB, CH, JS, P>::NT, smem, s>>>(
      (const T*)f1, (const T*)f2, (const T*)g, (T*)df1, (T*)df2, C, H, W, d, strips, span, vec);
  return (int)cudaGetLastError();
}

template <int R, int IS, int JS, int CC, int P, int MINB>
int launch_fwd(int dtype, const void* f1, const void* f2, void* out, int B, int C, int H, int W,
               int d, cudaStream_t s) {
  if (dtype == ocf::kF32)
    return launch_fwd_t<float, R, IS, JS, CC, P, MINB>(f1, f2, out, B, C, H, W, d, s);
  if (dtype == ocf::kBF16)
    return launch_fwd_t<__nv_bfloat16, R, IS, JS, CC, P, MINB>(f1, f2, out, B, C, H, W, d, s);
  return (int)cudaErrorInvalidValue;
}

template <int R, int CB, int CH, int JS, int P, int MINB>
int launch_bwd(int dtype, const void* f1, const void* f2, const void* g, void* df1, void* df2,
               int B, int C, int H, int W, int d, cudaStream_t s) {
  if (dtype == ocf::kF32)
    return launch_bwd_t<float, R, CB, CH, JS, P, MINB>(f1, f2, g, df1, df2, B, C, H, W, d, s);
  if (dtype == ocf::kBF16)
    return launch_bwd_t<__nv_bfloat16, R, CB, CH, JS, P, MINB>(f1, f2, g, df1, df2, B, C, H, W,
                                                               d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f1, f2: [B, C, H, W] contiguous; out: [B, (2d+1)^2, H, W] contiguous, one
// dtype; d >= 1. Returns cudaGetLastError() after the launch.
extern "C" int ocf_cost_volume_any_fwd(int dtype, const void* f1, const void* f2,
                                       void* out, int B, int C, int H, int W, int d,
                                       void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || d < 1) return (int)cudaErrorInvalidValue;
  return launch_fwd<CV_ANY_FWD>(dtype, f1, f2, out, B, C, H, W, d, (cudaStream_t)stream);
}

// f1, f2, df1, df2: [B, C, H, W] contiguous; g: [B, (2d+1)^2, H, W]
// contiguous, all of one dtype; d >= 1. Returns cudaGetLastError() after the
// launch.
extern "C" int ocf_cost_volume_any_bwd(int dtype, const void* f1, const void* f2,
                                       const void* g, void* df1, void* df2, int B, int C,
                                       int H, int W, int d, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || d < 1) return (int)cudaErrorInvalidValue;
  return launch_bwd<CV_ANY_BWD>(dtype, f1, f2, g, df1, df2, B, C, H, W, d,
                                (cudaStream_t)stream);
}
