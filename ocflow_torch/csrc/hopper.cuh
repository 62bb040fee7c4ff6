// Hopper (sm_90a) building blocks shared by the TMA / wgmma kernels
// (gemm_probe.cu, conv_group_tma.cu, conv_group_q8_tma.cu,
// conv_group_dw.cu): mbarriers, TMA and bulk loads, wgmma shared-memory
// descriptors and fences, setmaxnreg, the shift of a swizzled window by
// one pixel,
// the run-time lookup of cuTensorMapEncodeTiled and a cache of encoded
// tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <type_traits>
#include <unordered_map>

namespace ocf {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// returns once the phase of parity `parity` has completed; a ring that
// never completes (a broken phase) traps, seconds on, instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && ++tries == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// box at (c0 innermost, c1) of the map into shared memory; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 4-d map; coordinates may lie outside the tensor (TMA
// fills those elements with zeros and still counts their bytes)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory; completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor; offsets in bytes. layout: 0 = no swizzle
// (8-row core matrices of 16 bytes), 1 = 128-byte swizzle, 2 = 64-byte,
// 3 = 32-byte
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (no code)
template <typename Acc, int N>
__device__ __forceinline__ void fence_acc(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same_v<Acc, float>)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// named barrier `id` over `n` threads (whole warps)
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a warpgroup's register budget: the producer gives registers up, the
// consumers take them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// byte offset of a swizzled box's logical offset `off`: the 16-byte chunk
// bits XOR the 128-byte line bits, `mask` = 7, 3, 1 for the 128-, 64-,
// 32-byte swizzle (the box starts on 1 KB)
__device__ __forceinline__ int swizzled(int off, int mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// The stage's dx = 1 window `a + box` (16 x (R + 2) lines of C pixels,
// swizzled) holds columns x0 .. x0 + C - 1; write the windows of dx = 0
// (columns x0 - 1 .., each line's first pixel from the left strip) at `a`
// and dx = 2 (x0 + 1 .., the last from the right strip) at `a + 2 box`.
// Shift thread t of SHIFTERS takes whole lines: it loads a line's C / 8
// chunks, then stores both shifted lines. The strips: boxes of 8 pixels
// of the same lines, unswizzled, left at `strips`, right at `strips +
// strip`. (conv_group_tma.cu: a line is 16 channels' pixels of one row;
// conv_group_dw.cu: the same at 64 pixels.)
template <int SHIFTERS>
__device__ __forceinline__ void shift_lines(unsigned char* a, int box,
                                           const unsigned char* strips, int strip, int lines,
                                           int tc, int t) {
  const int lg = tc == 64 ? 3 : tc == 32 ? 2 : 1, mask = (1 << lg) - 1;
  const unsigned char* src = a + box;
  for (int line = t; line < lines; line += SHIFTERS) {
    const int base = line << (lg + 4);
    uint4 c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j <= mask) c[j] = *reinterpret_cast<const uint4*>(src + swizzled(base + 16 * j, mask));
    const unsigned left = *reinterpret_cast<const unsigned*>(strips + 16 * line + 12);
    const unsigned right = *reinterpret_cast<const unsigned*>(strips + strip + 16 * line);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > mask) break;
      const uint4 v = c[j];
      const unsigned w0 = j == 0 ? left : c[j > 0 ? j - 1 : 0].w;
      const unsigned w2 = j == mask ? right : c[j < 7 ? j + 1 : 7].x;
      const int off = swizzled(base + 16 * j, mask);
      *reinterpret_cast<uint4*>(a + off) =
          make_uint4(__byte_perm(w0, v.x, 0x5432), __byte_perm(v.x, v.y, 0x5432),
                     __byte_perm(v.y, v.z, 0x5432), __byte_perm(v.z, v.w, 0x5432));
      *reinterpret_cast<uint4*>(a + 2 * box + off) =
          make_uint4(__byte_perm(v.x, v.y, 0x5432), __byte_perm(v.y, v.z, 0x5432),
                     __byte_perm(v.z, v.w, 0x5432), __byte_perm(v.w, w2, 0x5432));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the tensor map encoder, from the libcuda the runtime has loaded (no
// -lcuda at build time)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A tensor map only describes an address, a shape and a box (no driver
// state), so a map encoded once is reused for the same arguments: the
// stripes and weights of a forward come back at the same addresses, and
// cuTensorMapEncodeTiled costs the host microseconds a map.
struct MapKey {
  const void* ptr;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  int rank, swizzle, dtype;
};

// the maps encoded so far (cache misses), for tests of the cache
inline long long& map_encodes() {
  static long long n = 0;
  return n;
}

// encodes k (its unused dims, strides and box entries zero) into map, or
// copies the map encoded for the same key; 0 or a CUDA error code
inline int encode_cached(CUtensorMap* map, const MapKey& k) {
  // one forward uses ~600 maps; the bound only keeps a long run of changing
  // addresses from growing the table without end
  constexpr size_t MAX_MAPS = 8192;
  static std::unordered_map<std::string, CUtensorMap> cache;
  static std::mutex mu;
  const std::string key(reinterpret_cast<const char*>(&k), sizeof(MapKey));
  const std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r =
      enc(map, static_cast<CUtensorMapDataType>(k.dtype), k.rank, const_cast<void*>(k.ptr),
          k.dims, k.strides, k.box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
          static_cast<CUtensorMapSwizzle>(k.swizzle), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  ++map_encodes();
  if (cache.size() >= MAX_MAPS) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// the SMs of the current device (read once)
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace ocf
