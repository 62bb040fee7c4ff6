// GEMM probe, int8 -> int32 and bf16 -> fp32, for Hopper (sm_90a): a TMA
// ring, a producer warp and wgmma consumers.
//
// Replaces the TPU probe tools/spike_int8.py `make_pallas` (a Pallas GEMM
// with full-K blocks that measured the TPU's int8 and bf16 matrix-unit
// rates): C[M, N] = A[M, K] . B[K, N], all row-major. It measures what a
// hand-written tensor-core GEMM reaches on this card, the yardstick for
// the W8A8 conv kernel (conv_group_q8.cu), beside the library GEMMs.
//
// Bound at 2048^3: operations (int8 17.2 GOP at 1979 TOP/s = 8.7 us; bf16
// at 989 TFLOP/s = 17.4 us). The bytes (A and B read once, the 4-byte C
// written once: 8 or 16 MB in, 16 MB out) take 7.5 / 10.0 us at 3.35 TB/s.
//
// Design, for 2048^3 on 132 SMs:
// - One wave of 128 tiles: bf16 tiles of 128 x 256 of C, int8 256 x 128.
//   Per 128 bytes of K the two consumers' wgmmas read 80 KB of shared
//   memory and the TMA writes 48 KB into it, 125 B/clk at the tensor
//   cores' rate against the SM's 128: the tile is as large as shared memory
//   lets the tensor cores run. 128 x 128 tiles (two per block at 2048^2,
//   each stored by TMA while the next one computes) need 160 B/clk and ran
//   slower on the card. Blocks are persistent: the grid is min(tiles, SMs)
//   and block b takes tiles b, b + grid, ...; the ring keeps its stage and
//   phase from one tile to the next, so the producer loads the next tile
//   while the consumers store this one.
// - K in blocks of 128 bytes (64 bf16, 128 int8), the span of the 128-byte
//   swizzle, through a ring of 4 stages of 48 KB in dynamic shared memory,
//   each stage with a full and an empty mbarrier.
// - Warpgroup 0 is the producer (setmaxnreg 40): one thread waits for a
//   stage's empty barrier, arms its full barrier with the stage's bytes
//   and issues the TMA loads (cp.async.bulk.tensor, 128-byte swizzle).
//   Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 128 accumulators
//   a thread: per K block, wait for the full barrier, fence, four wgmma
//   m64n256 (K slices of 32 bytes), commit, wait, release the stage (one
//   arrive per warp, 8 a phase). Nothing else synchronizes the block.
// - bf16 (m64n256k16, f32 sums): each consumer takes 64 rows of the tile.
//   A is K-major; B [K, N] is read MN-major through the descriptor's
//   transpose bit, as four TMA boxes of 64 N x 64 K (LBO 8 KB between the
//   boxes, SBO 1 KB between 8-deep K groups). The wait leaves one group in
//   flight, so the next K block's wgmmas queue behind it.
// - int8 (m64n256k32, s32 sums): wgmma takes 8-bit operands from shared
//   memory K-major only, and B [K, N] is N-major. So the roles swap: the
//   wgmma computes C^T = B^T A^T, its B operand A's 256 rows (K-major,
//   SBO 1 KB), its A operand each consumer's 64 columns of B from
//   registers. The consumer loads them with ldmatrix .trans (16-bit
//   elements: pairs of N bytes over K) and one byte permute per register;
//   its 64 rows of the wgmma are then N in pairs (row g is N 2g, row g + 8
//   N 2g + 1 of each warp's 16), and the epilogue writes C^T's fragments
//   back as C. No transposing pass over B, which a first version ran
//   before every call and which took longer than these waits. The wait
//   drains the group before the next K block's fragments overwrite the
//   registers the wgmmas read (the compiler does not keep them); the other
//   consumer's wgmmas fill the tensor cores meanwhile.
// - Epilogue: accumulators straight from registers to global memory, 8
//   bytes a store, every 32-byte sector whole. It is not hidden at 2048^3:
//   one wave, so every block stores at its end, 16 MB in all, 5.0 us at
//   3.35 TB/s (the probe times a plain 16 MB fill beside it: PERF.md).
//   With more tiles than SMs the producer's loads of the next tile overlap
//   it.
// The tensor maps are encoded on the host at every call
// (cuTensorMapEncodeTiled, looked up in libcuda at run time). The PTX
// wrappers and that lookup live in hopper.cuh, shared with
// conv_group_tma.cu.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// C tile: bf16 128 x 256, int8 256 x 128 (the wgmma's rows are N there)
template <bool INT8>
struct Tile {
  static constexpr int M = INT8 ? 256 : 128, N = INT8 ? 128 : 256;
};
constexpr int BKB = 128;      // K bytes per stage (the swizzle span)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumers
constexpr int STAGE_BYTES = 384 * BKB;  // A and B tiles: 48 KB in either type
// the ring, its 2 x STAGES barriers, and room to align the base to 1 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

using ocf::fence_acc;
using ocf::mbar_arrive;
using ocf::mbar_expect_tx;
using ocf::mbar_init;
using ocf::mbar_wait;
using ocf::smem_desc;
using ocf::smem_u32;
using ocf::tma_load;
using ocf::wgmma_commit;
using ocf::wgmma_fence;
using ocf::wgmma_wait;

#define OCF_D128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "        \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "  \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127}"
#define OCF_ACC8(C, i) \
  C(d[i + 0]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define OCF_ACC128(C)                                                                      \
  OCF_ACC8(C, 0), OCF_ACC8(C, 8), OCF_ACC8(C, 16), OCF_ACC8(C, 24), OCF_ACC8(C, 32),        \
      OCF_ACC8(C, 40), OCF_ACC8(C, 48), OCF_ACC8(C, 56), OCF_ACC8(C, 64), OCF_ACC8(C, 72), \
      OCF_ACC8(C, 80), OCF_ACC8(C, 88), OCF_ACC8(C, 96), OCF_ACC8(C, 104), OCF_ACC8(C, 112), \
      OCF_ACC8(C, 120)
#define OCF_F(x) "+f"(x)
#define OCF_R(x) "+r"(x)

// d (+)= A[64 x 16] . B[16 x 256]: A K-major, B MN-major (transpose bit)
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " OCF_D128
      ", %128, %129, p, 1, 1, 0, 1;\n}"
      : OCF_ACC128(OCF_F)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A[64 x 32] . B[32 x 256]: A from registers (a[0..3], four s8 a
// register: a[0] row g = lane / 4, K 4t .. 4t + 3 with t = lane % 4; a[1]
// row g + 8; a[2], a[3] the same 16 K further), B K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " OCF_D128
      ", {%128, %129, %130, %131}, %132, p;\n}"
      : OCF_ACC128(OCF_R)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// four 8 x 8 matrices of 16-bit elements, transposed: lane l gives row
// l % 8 of matrix l / 8; r[i] gets matrix i's rows 2t and 2t + 1 (t = lane
// % 4) at column lane / 4, the first in the low half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, void* __restrict__ out, int M,
                int N, int K) {
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int TM = Tile<INT8>::M, TN = Tile<INT8>::N;
  constexpr int KE = INT8 ? BKB : BKB / 2;  // K elements per stage
  constexpr int A_BYTES = TM * BKB;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: stages start on 1 KB
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = N / TN, tiles = (M / TM) * tiles_n, kblocks = K / KE;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    ocf::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    ocf::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * TM, n0 = (t % tiles_n) * TN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = smem + s * STAGE_BYTES;
          unsigned char* sb = sa + A_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load(sa, &tm_a, &full[s], kb * KE, m0);  // TM rows of 128 K bytes
          if constexpr (INT8) {
            tma_load(sb, &tm_b, &full[s], n0, kb * KE);  // B: 128 K rows of 128 N
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)  // B: 64 K rows of 64 N, four boxes along N
              tma_load(sb + j * 8192, &tm_b, &full[s], n0 + 64 * j, kb * KE);
          }
        }
      }
    }
  } else {
    // consumers: bf16 rows 64 cw of the tile; int8 columns 64 cw
    ocf::setmaxnreg_inc<232>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // int8: this lane's ldmatrix row in each K slice of 32: matrix i = lane
    // / 8 holds K rows 4 (j / 2) + j % 2 + 2 (i % 2) + 16 (i / 2) (j = lane
    // % 8), so that r[0], r[1] give lane t K 4t .. 4t + 3 of the first 16
    // and r[2], r[3] of the next; its 16 columns are the warp's 16 N of the
    // consumer's 64, as 8 pairs of bytes (the 16-bit elements). The
    // wgmma's row g is then N 2g of the warp's 16 and row g + 8 is N 2g + 1.
    const int ld_k = 4 * ((lane % 8) / 2) + lane % 2 + 2 * ((lane / 8) % 2) + 16 * (lane / 16);
    const int ld_chunk = 4 * cw + warp;  // 16-byte chunk of the 128 N bytes of a K row
    Acc d[128];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * TM, n0 = (t % tiles_n) * TN;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t sa = smem_u32(smem + s * STAGE_BYTES);
        const uint32_t sb = sa + A_BYTES;
        if constexpr (INT8) {
          uint32_t frag[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // K slices of 32
            const int k = 32 * j + ld_k;
            uint32_t r[4];
            ldmatrix_x4_trans(r, sb + k * 128 + ((ld_chunk ^ (k % 8)) * 16));
            // r[0] bytes: (K 4t, N 2g), (4t, 2g + 1), (4t + 1, 2g), (4t + 1, 2g + 1);
            // r[1] the same at K + 2
            frag[j][0] = __byte_perm(r[0], r[1], 0x6420);
            frag[j][1] = __byte_perm(r[0], r[1], 0x7531);
            frag[j][2] = __byte_perm(r[2], r[3], 0x6420);
            frag[j][3] = __byte_perm(r[2], r[3], 0x7531);
          }
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)  // the wgmma's B: A's 256 rows, K-major
            wgmma_s8(d, frag[j], smem_desc(sa + 32 * j, 16, 1024), kb > 0 || j > 0);
        } else {
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)  // K slices of 16: A K-major, B 16 K rows a slice
            wgmma_bf16(d, smem_desc(sa + cw * 8192 + 32 * j, 16, 1024),
                       smem_desc(sb + 2048 * j, 8192, 1024), kb > 0 || j > 0);
        }
        wgmma_commit();
        if constexpr (INT8) {
          // the next K block's fragments reuse these registers, which the
          // wgmmas read until they are done (nothing in the compiler keeps
          // them): wait for this group, then release its stage. The other
          // consumer's wgmmas fill the tensor cores meanwhile
          wgmma_wait<0>();
          fence_acc(d);
          if (lane == 0) mbar_arrive(&empty[s]);
        } else {
          wgmma_wait<1>();  // the previous K block's group is done
          fence_acc(d);
          if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      if constexpr (!INT8) {
        wgmma_wait<0>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }

      // d[4j + {0, 1}] is the wgmma's row warp * 16 + lane / 4, columns 8j
      // + 2 (lane % 4) + {0, 1}; d[4j + {2, 3}] the row 8 below
      if constexpr (INT8) {
        // rows are N (2 (lane / 4), + 1 of the warp's 16), columns M
        int* at = static_cast<int*>(out) + static_cast<long long>(m0 + 2 * (lane % 4)) * N +
                  n0 + 64 * cw + 16 * warp + 2 * (lane / 4);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          *reinterpret_cast<int2*>(at + 8LL * j * N) = make_int2(d[4 * j], d[4 * j + 2]);
          *reinterpret_cast<int2*>(at + (8LL * j + 1) * N) = make_int2(d[4 * j + 1], d[4 * j + 3]);
        }
      } else {
        float* row = static_cast<float*>(out) +
                     static_cast<long long>(m0 + cw * 64 + warp * 16 + lane / 4) * N + n0 +
                     2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          *reinterpret_cast<float2*>(row + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
          *reinterpret_cast<float2*>(row + 8LL * N + 8 * j) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
        }
      }
    }
  }
}

// a row-major [rows, cols] matrix, boxes of box_cols x box_rows, 128-byte
// swizzle
int encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows, int cols,
           int elem_bytes, int box_cols, int box_rows) {
  const ocf::EncodeTiled enc = ocf::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool INT8>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int M, int N, int K,
           cudaStream_t s) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      gemm_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (attr != 0) return attr;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = (M / Tile<INT8>::M) * (N / Tile<INT8>::N);
  gemm_kernel<INT8><<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, s>>>(ma, mb, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A . B, row-major; dtype 0: int8 A, B -> int32 C, M a multiple of 256
// and N of 128; 1: bf16 -> fp32, M a multiple of 128 and N of 256. K a
// multiple of 128 bytes (128 int8, 64 bf16); every pointer 16-byte aligned.
// Returns the first CUDA error of the encodes and the launch.
extern "C" int ocf_gemm(int dtype, const void* a, const void* b, void* c, int M, int N, int K,
                        void* stream) {
  const int tm = dtype == 0 ? 256 : 128, tn = dtype == 0 ? 128 : 256;
  const int ke = dtype == 0 ? BKB : BKB / 2;
  if ((dtype != 0 && dtype != 1) || M < tm || N < tn || K < ke || M % tm || N % tn || K % ke)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma, mb;
  int err;
  if (dtype == 0) {
    if ((err = encode(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, M, K, 1, BKB, 256)) != 0 ||
        (err = encode(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, K, N, 1, 128, BKB)) != 0)
      return err;
    return launch<true>(ma, mb, c, M, N, K, s);
  }
  if ((err = encode(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, M, K, 2, BKB / 2, 128)) != 0 ||
      (err = encode(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, K, N, 2, 64, BKB / 2)) != 0)
    return err;
  return launch<false>(ma, mb, c, M, N, K, s);
}
