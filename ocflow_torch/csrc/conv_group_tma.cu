// One bf16 3x3 convolution of stride 1 and dilation 1 of a conv group,
// for Hopper (sm_90a): a TMA ring, a producer warp, shift warps, wgmma
// consumers and split K.
//
// Replaces, beside conv_group.cu, the TPU kernel
// ocflow_tpu/ops/pallas/conv_chain_kernel.py `conv_group` (body
// `_kernel_body`) for every conv it takes (kernels/conv_chain.py:is_tma):
// bf16, stride 1, dilation 1, rows of 16-byte multiples. It also runs the
// forward of `conv_group_diff` (conv_chain_kernel.py:1198). The other
// convs of a group (stride 2, dilated, fp32, rows of other widths) stay on
// conv_group.cu.
//
// Its adjoint epilogue (mode 1) runs the dX half of `conv_group_diff`'s
// backward (the XLA adjoint `_diff_bwd`, conv_chain_kernel.py:1258): the
// cotangent of a block is a conv of the gradient stripe segment of the
// convs that read it, with their weights flipped in space and in and out
// channels swapped (kernels/conv_chain.py:adjoint_packed), plus the
// block's own output cotangent, times LeakyReLU' of its saved activation;
// fp32 sums, one rounding at the store (conv_group_dw.cu takes dW and db).
//
// Bound on the H100: operations for the decoders' wide convs (K = 9 Cin up
// to ~5,000 against 32-128 couts: 0.85 ms of tensor-core time for the
// 448x1024 level-2 group at 989 TFLOP/s), bytes for the narrow encoder
// and head convs. It is the implicit GEMM
//   out[p, co] = sum_k X[p, k] W[k, co],  k = (chunk, dx, dy, channel)
// with M = an R x C tile of one image's output pixels, N = the conv's
// couts (one wgmma n of 16, 32, 64, 96 or 128; 128-wide tiles past 128).
// What limits it on the card is L2: each tile reads its input rows and all
// the weights of its couts from L2 (PERF.md gives the bytes), so the design
// reads each input row once per chunk and keeps the taps in shared memory.
//
// Design:
// - Tiles of 256 output pixels, C = 64 columns (16 or 32 where the image
//   is that narrow) by R = 256 / C rows. Two consumer warpgroups take 128
//   pixels each, as two m64 wgmmas on the same B: 2 x NT / 2 fp32
//   accumulators a thread (128 at NT = 128).
// - K runs over the conv's channel chunks (16 channels of one channel
//   segment: the stripe's blocks or a group input; past a segment's end
//   TMA fills zeros) and, inside a chunk, over the 9 taps. One stage of the
//   ring is one chunk: its input rows y0 - 1 .. y0 + R at the tile's own
//   columns (one TMA box), an 8-pixel strip on each side, and the 9 taps'
//   weights. The taps read the rows one row apart for dy (a row is one
//   LBO), so each input element crosses from L2 (R + 2) / R times per
//   chunk, and each weight once per tile.
// - A (the pixels) comes MN-major: each segment's tensor map has the dims
//   (W, C_seg, H, B), so the box (C, 16, R + 2, 1) lands as R + 2 blocks of
//   [16 channels][C pixels], with the 128-, 64- or 32-byte swizzle that a C
//   of 64, 32 or 16 bf16 spans. That is wgmma's canonical MN-major layout:
//   atoms of C pixels x 8 channels, LBO = 32 C bytes between tile rows,
//   SBO = 16 C bytes between 8-channel groups; the descriptor's transpose
//   bit reads it, and no fragment is loaded.
// - A box's innermost coordinate must be a multiple of 16 bytes (the card
//   refuses x0 - 1 with an illegal instruction), so the rows are loaded at
//   the tile's own columns: the window of dx = 1. Three shift warps write
//   the windows of dx = 0 and 2 beside them in the same stage: each thread
//   loads a line of C pixels and stores it moved one pixel right (the
//   first pixel from the left strip) and one pixel left (the last from the
//   right strip); then a proxy fence and the stage's ready barrier. The
//   consumers never wait on a shift but the stage's own.
// - The conv's padding, and the channels past a segment's end, come from
//   TMA's zero fill of out-of-bounds boxes (which still count their bytes
//   toward the stage's transaction count); the weight rows of the padded
//   channels are zeros too (pack_tma_weights in kernels/conv_chain.py).
// - B (the weights) comes MN-major from the packed [ntiles][chunks][9]
//   [16] rows of NT couts (96 padded to 128): per stage one or two boxes of
//   144 rows (the 9 taps' 16 channels) x 64 couts (128-byte swizzle; 16
//   and 32 couts: 32- and 64-byte), read through the transpose bit. Rows of
//   128 bytes: the TMA engine fetches a stage's weights in 288 rows, where
//   K-major rows of 16 channels took 1,152 of 32 bytes and measured slower
//   (PERF.md).
// - A ring of 3 stages of up to 75 KB, each with a full (TMA), a ready
//   (shifted) and an empty mbarrier. Warpgroup 0 holds the producer (one
//   thread issues the TMA loads) and the shift warps (1-3), at setmaxnreg
//   104; warpgroups 1 and 2 consume (setmaxnreg 200), keeping one wgmma
//   group in flight and releasing a stage when its group is done. Blocks
//   are persistent (grid = min(work units, SMs)), so the producer loads the
//   next unit while the consumers store this one.
// - Split K: where the tiles would not fill one wave of the 132 SMs (the
//   coarse levels), the wrapper splits the chunks over `split` blocks
//   (kernels/conv_chain.py:tma_split), which write fp32 partial sums to a
//   workspace; a second pass sums them in split order.
// - Epilogue: bias + LeakyReLU(0.1) in fp32, one rounding to bf16, stored
//   into the conv's channel range of the stripe ([B, cout, H, W] at the
//   stripe's batch stride), masked past H and W and cout: the staged
//   kernel's epilogue. Its 2-byte stores cost ~9% of the kernel's time over
//   the forward; pairing pixels by a lane trade into 4-byte stores measured
//   no faster (PERF.md).
// The tensor maps are encoded on the host, and kept for calls with the
// same addresses and shapes.

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ocf;

constexpr int MAXSEG = 8;
constexpr int MAXCHUNK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 384;  // producer and shift warps + 2 consumer warpgroups
constexpr int SHIFTERS = 96;  // warps 1-3
constexpr int TILE = 256;     // output pixels per tile
constexpr int MSUB = 2;       // m64 wgmmas per consumer
constexpr int KC = 16;        // channels per chunk: one wgmma K, 32 bytes
constexpr int NTMAX = 128;
// one stage at most (Stage below, at C = 64): 75 KB
constexpr int STAGE_MAX = 76800;
// the ring, its 3 x STAGES barriers, and room to align the base to 1 KB
constexpr int SMEM_BYTES = STAGES * STAGE_MAX + 3 * STAGES * 8 + 1024;

struct Maps {
  CUtensorMap seg[MAXSEG];    // per channel segment: (W, C_seg, H, B), boxes (C, 16, R + 2, 1)
  CUtensorMap strip[MAXSEG];  // the same tensor, boxes (8, 16, R + 2, 1), no swizzle
  CUtensorMap w;              // packed weights: (NTP couts, rows)
};

struct Args {
  int chunk[MAXCHUNK];  // segment | first channel << 3
  int nchunk, H, W, tc, tiles_x, tiles_y, ntn, split, units, cout, act;
  long long out_bstride;
  __nv_bfloat16* out;
  const float* bias;    // null: the adjoint epilogue
  float* ws;  // split > 1: [split][tiles * ntn][NT][TILE] fp32
  // the adjoint epilogue: out (+)= gout, x LeakyReLU'(actv) (either null:
  // none); [B, cout, H, W] at their batch strides
  const __nv_bfloat16* gout;
  const __nv_bfloat16* actv;
  long long gout_bstride, act_bstride;
};

// A stage's layout for tile columns tc: the windows of dx = 0, 1, 2 (boxes
// of (tc, 16, R + 2)) at box * dx, the left and right strips at strips and
// strips + strip, the weights at `weights`: box b of couts b BN .. at
// 144 BN 2 b, tap t's 16 channels 32 BN t further; every part on 1 KB where
// the swizzle needs it
struct Stage {
  int box, strip, strips, weights, bytes;
  __host__ __device__ explicit Stage(int tc) {
    const int rows = TILE / tc + 2;
    box = KC * rows * tc * 2;
    strip = KC * rows * 16;
    strips = 3 * box;
    weights = strips + 2 * strip;
    bytes = (weights + 9 * NTMAX * KC * 2 + 1023) / 1024 * 1024;
  }
};

// d (+)= A[64 x 16] . B[16 x N]: both MN-major (the transpose bits)
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<96>(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}


// a work unit: (tile, cout tile, K split) -> its origin and chunk range
struct Unit {
  int b, y0, x0, nt, sp, un, s0, s1;
  __device__ Unit(const Args& a, int u) {
    sp = u % a.split;
    un = u / a.split;
    nt = un % a.ntn;
    const int tile = un / a.ntn, per_img = a.tiles_x * a.tiles_y;
    b = tile / per_img;
    const int t = tile - b * per_img;
    y0 = (t / a.tiles_x) * (TILE / a.tc);
    x0 = (t % a.tiles_x) * a.tc;
    s0 = sp * a.nchunk / a.split;
    s1 = (sp + 1) * a.nchunk / a.split;
  }
};

__device__ __forceinline__ float epilogue(float v, float bias, int act) {
  v += bias;
  return act && v < 0.f ? 0.1f * v : v;
}

// the sum v of output (b, co, pixel p = y W + x) finished: bias and
// LeakyReLU, or (adjoint) + gout, x 0.1 where the saved activation is
// negative
__device__ __forceinline__ float finish(const Args& a, float v, int b, int co, long long p) {
  if (a.bias != nullptr) return epilogue(v, a.bias[co], a.act);
  const long long at = (long long)co * a.H * a.W + p;
  if (a.gout != nullptr) v += __bfloat162float(a.gout[b * a.gout_bstride + at]);
  if (a.actv != nullptr && __bfloat162float(a.actv[b * a.act_bstride + at]) < 0.f) v *= 0.1f;
  return v;
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_tma_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args args) {
  constexpr int NA = NT / 2;  // accumulators per m64 wgmma and thread
  // packed couts a row (NT, 96 padded to 128) and couts a weight box
  constexpr int NTP = NT == 96 ? 128 : NT, BN = NTP < 64 ? NTP : 64;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: stages start on 1 KB
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tc = args.tc, rows = TILE / tc + 2;
  const Stage lay(tc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_MAX);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SHIFTERS);  // every shift thread, every stage
      mbar_init(&empty[s], 8);         // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<104>();
    int it = 0;
    if (threadIdx.x == 0) {
      // producer: one thread keeps the ring full
      for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
        const Unit w(args, u);
        for (int st = w.s0; st < w.s1; ++st, ++it) {
          const int info = args.chunk[st], seg = info & 7, c0 = info >> 3;
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = smem + s * STAGE_MAX;
          mbar_expect_tx(&full[s], lay.box + 2 * lay.strip + 9 * KC * NTP * 2);
          tma_load_4d(sa + lay.box, &maps.seg[seg], &full[s], w.x0, c0, w.y0 - 1, w.b);
          tma_load_4d(sa + lay.strips, &maps.strip[seg], &full[s], w.x0 - 8, c0, w.y0 - 1, w.b);
          tma_load_4d(sa + lay.strips + lay.strip, &maps.strip[seg], &full[s], w.x0 + tc, c0,
                      w.y0 - 1, w.b);
          for (int nb = 0; nb < NTP / BN; ++nb)
            tma_load(sa + lay.weights + nb * 9 * KC * BN * 2, &maps.w, &full[s], nb * BN,
                     (w.nt * args.nchunk + st) * 9 * KC);
        }
      }
    } else if (threadIdx.x >= 32) {
      // shift warps: each stage's dx = 0 and 2 windows once its boxes have landed
      const int t = threadIdx.x - 32;
      for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
        const Unit w(args, u);
        for (int st = w.s0; st < w.s1; ++st, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          unsigned char* sa = smem + s * STAGE_MAX;
          shift_lines<SHIFTERS>(sa, lay.box, sa + lay.strips, lay.strip, KC * rows, tc, t);
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {
    // consumers: pixels 128 cw .. 128 cw + 127 of the tile
    setmaxnreg_inc<200>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const uint32_t lbo = 32 * tc, sbo = 16 * tc, layout = tc == 64 ? 1 : tc == 32 ? 2 : 3;
    float d[MSUB][NA];
    int it = 0;
    for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
      const Unit w(args, u);
      for (int st = w.s0; st < w.s1; ++st, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);  // the TMA bytes, then the shifts
        mbar_wait(&ready[s], (it / STAGES) & 1);
        const uint32_t sa = smem_u32(smem + s * STAGE_MAX), sb = sa + lay.weights;
#pragma unroll
        for (int i = 0; i < MSUB; ++i) fence_acc(d[i]);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            // B: tap (dy, dx)'s 16 channel rows of the couts; A: the dx
            // window from row dy, this m64's 64 pixels (2 KB of rows
            // whatever C is)
            const uint64_t db = smem_desc(sb + (3 * dy + dx) * KC * BN * 2, 9 * KC * BN * 2,
                                          8 * BN * 2, BN == 64 ? 1 : BN == 32 ? 2 : 3);
#pragma unroll
            for (int i = 0; i < MSUB; ++i)
              wgmma_tn<NT>(d[i],
                           smem_desc(sa + dx * lay.box + (cw * MSUB + i) * 2048 + dy * lbo,
                                     lbo, sbo, layout),
                           db, st > w.s0 || dx > 0 || dy > 0);
          }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done
#pragma unroll
        for (int i = 0; i < MSUB; ++i) fence_acc(d[i]);
        if (st > w.s0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MSUB; ++i) fence_acc(d[i]);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // d[i][4j + {0, 1}]: pixel (cw MSUB + i) 64 + warp 16 + lane / 4,
      // couts 8j + 2 (lane % 4) + {0, 1}; d[i][4j + {2, 3}] the pixel 8 on
      const long long hw = (long long)args.H * args.W;
#pragma unroll
      for (int i = 0; i < MSUB; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pm = (cw * MSUB + i) * 64 + warp * 16 + lane / 4 + 8 * h;
          if (args.ws != nullptr) {
            float* p = args.ws +
                       ((long long)(w.sp * (args.units / args.split) + w.un) * NT) * TILE +
                       pm;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                p[(8 * j + 2 * (lane % 4) + e) * TILE] = d[i][4 * j + 2 * h + e];
            continue;
          }
          const int r = pm / tc, y = w.y0 + r, x = w.x0 + pm - r * tc;
          if (y >= args.H || x >= args.W) continue;
          __nv_bfloat16* o = args.out + w.b * args.out_bstride + (long long)y * args.W + x;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = w.nt * NT + 8 * j + 2 * (lane % 4) + e;
              if (co < args.cout)
                o[co * hw] = __float2bfloat16(
                    finish(args, d[i][4 * j + 2 * h + e], w.b, co, (long long)y * args.W + x));
            }
        }
      }
    }
  }
}

// the split-K pass: one thread per (unit, cout, pixel) sums the splits'
// partials in split order, then the epilogue
__global__ void __launch_bounds__(256)
    split_reduce_kernel(const __grid_constant__ Args args, int nt_width) {
  const long long per_split = (long long)(args.units / args.split) * nt_width * TILE;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_split) return;
  const int pm = (int)(idx % TILE), col = (int)(idx / TILE % nt_width);
  const Unit w(args, (int)(idx / ((long long)TILE * nt_width)) * args.split);
  const int co = w.nt * nt_width + col;
  const int r = pm / args.tc, y = w.y0 + r, x = w.x0 + pm - r * args.tc;
  if (co >= args.cout || y >= args.H || x >= args.W) return;
  float v = args.ws[idx];
  for (int sp = 1; sp < args.split; ++sp) v += args.ws[sp * per_split + idx];
  const long long p = (long long)y * args.W + x;
  args.out[w.b * args.out_bstride + (long long)co * args.H * args.W + p] =
      __float2bfloat16(finish(args, v, w.b, co, p));
}

// channel segment s: (W, C_seg, H, B) with the plane, row and batch
// strides; boxes (tc, 16, 256 / tc + 2, 1) with the swizzle tc bf16 span,
// or for the strips (8, 16, 256 / tc + 2, 1) unswizzled
int encode_segment(CUtensorMap* map, const void* ptr, int W, int C, int H, int B,
                   long long bstride, int tc, bool strip) {
  MapKey k;
  std::memset(&k, 0, sizeof k);  // the padding too: keys compare as bytes
  k.ptr = ptr;
  k.rank = 4;
  k.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)H * W * 2, (cuuint64_t)W * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t box[4] = {strip ? 8u : (cuuint32_t)tc, (cuuint32_t)KC,
                             (cuuint32_t)(TILE / tc + 2), 1};
  std::memcpy(k.dims, dims, sizeof dims);
  std::memcpy(k.strides, strides, sizeof strides);
  std::memcpy(k.box, box, sizeof box);
  k.swizzle = strip      ? CU_TENSOR_MAP_SWIZZLE_NONE
              : tc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : tc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_cached(map, k);
}

// the packed weights: rows of ntp couts, boxes of 144 rows (9 taps x 16
// channels) x bn couts, with the swizzle bn bf16 span
int encode_weights(CUtensorMap* map, const void* ptr, long long rows, int ntp, int bn) {
  MapKey k;
  std::memset(&k, 0, sizeof k);
  k.ptr = ptr;
  k.rank = 2;
  k.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  k.dims[0] = (cuuint64_t)ntp;
  k.dims[1] = (cuuint64_t)rows;
  k.strides[0] = (cuuint64_t)ntp * 2;
  k.box[0] = (cuuint32_t)bn;
  k.box[1] = 9 * KC;
  k.swizzle = bn == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
              : bn == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_cached(map, k);
}

template <int NT>
int launch(const Maps& maps, const Args& args, cudaStream_t s) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      conv3x3_tma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (attr != 0) return attr;
  if (Stage(args.tc).bytes > STAGE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  conv3x3_tma_kernel<NT>
      <<<args.units < sms ? args.units : sms, THREADS, SMEM_BYTES, s>>>(maps, args);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || args.split == 1) return err;
  const long long n = (long long)(args.units / args.split) * NT * TILE;
  split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(args, NT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One conv: reads `nseg` channel segments (ptrs[i] at batch stride
// bstrides[i] elements, chans[i] channels, each [*, H, W] channel
// contiguous, 16-byte aligned, W a multiple of 8), writes cout channels of
// [H, W] at `out` with batch stride out_bstride. chunks[0 .. nchunk): the
// K chunks (segment | first channel << 3, 16 channels each), in the
// order of the packed weight `w`: wrows = ntn * nchunk * 9 * 16 rows of nt
// couts (96 padded to 128; kernels/conv_chain.py:pack_tma_weights). nt:
// couts per tile (16, 32, 64, 96, 128), ntn tiles. tc: tile columns (16, 32, 64).
// split > 1 splits K over blocks, with `ws` an fp32 workspace of split *
// B * tiles * ntn * nt * 256 floats. bias: fp32 [cout], or null for the
// adjoint epilogue: gout (bf16, or null) added, then x 0.1 where actv
// (bf16, or null) is negative, both [B, cout, H, W] channel contiguous at
// batch strides gout_bstride and act_bstride (act unused).
// Returns the first CUDA error of the encodes and the launches.
extern "C" int ocf_conv3x3_tma(int nseg, void** ptrs, const long long* bstrides,
                               const int* chans, int B, int H, int W, const int* chunks,
                               int nchunk, const void* w, long long wrows, int nt, int ntn,
                               const void* bias, void* out, long long out_bstride, int cout,
                               int act, int tc, int split, void* ws, const void* gout,
                               long long gout_bstride, const void* actv,
                               long long act_bstride, void* stream) {
  if (nseg < 1 || nseg > MAXSEG || nchunk < 1 || nchunk > MAXCHUNK || B < 1 || H < 1 ||
      W < 8 || W % 8 || (tc != 16 && tc != 32 && tc != 64) || ntn < 1 || cout < 1 ||
      cout > nt * ntn || wrows != (long long)ntn * nchunk * 9 * KC || split < 1 ||
      split > nchunk || (split > 1) != (ws != nullptr) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  Args args;
  for (int i = 0; i < nseg; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || bstrides[i] % 8 || chans[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    int err = encode_segment(&maps.seg[i], ptrs[i], W, chans[i], H, B, bstrides[i], tc, false);
    if (err == 0)
      err = encode_segment(&maps.strip[i], ptrs[i], W, chans[i], H, B, bstrides[i], tc, true);
    if (err != 0) return err;
  }
  for (int i = nseg; i < MAXSEG; ++i) {
    maps.seg[i] = maps.seg[0];
    maps.strip[i] = maps.strip[0];
  }
  for (int i = 0; i < MAXCHUNK; ++i) {
    args.chunk[i] = i < nchunk ? chunks[i] : 0;
    if (i < nchunk && (chunks[i] & 7) >= nseg) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntp = nt == 96 ? 128 : nt;
  int err = encode_weights(&maps.w, w, wrows, ntp, ntp < 64 ? ntp : 64);
  if (err != 0) return err;
  args.nchunk = nchunk;
  args.H = H;
  args.W = W;
  args.tc = tc;
  args.tiles_x = (W + tc - 1) / tc;
  args.tiles_y = (H + TILE / tc - 1) / (TILE / tc);
  args.ntn = ntn;
  args.split = split;
  args.units = B * args.tiles_y * args.tiles_x * ntn * split;
  args.cout = cout;
  args.act = act;
  args.out_bstride = out_bstride;
  args.out = static_cast<__nv_bfloat16*>(out);
  args.bias = static_cast<const float*>(bias);
  args.ws = static_cast<float*>(ws);
  args.gout = static_cast<const __nv_bfloat16*>(gout);
  args.actv = static_cast<const __nv_bfloat16*>(actv);
  args.gout_bstride = gout_bstride;
  args.act_bstride = act_bstride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 16: return launch<16>(maps, args, s);
    case 32: return launch<32>(maps, args, s);
    case 64: return launch<64>(maps, args, s);
    case 96: return launch<96>(maps, args, s);
    case 128: return launch<128>(maps, args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
