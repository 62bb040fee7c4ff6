// One W8A8 3x3 convolution of stride 1 and dilation 1 of a conv group, for
// Hopper (sm_90a): a TMA ring, a producer warp, int8 wgmma consumers and
// split K.
//
// Replaces, beside conv_group_q8.cu, the TPU kernel
// ocflow_tpu/ops/pallas/conv_chain_kernel.py `conv_group_q8` (body
// `_q8_kernel_body`) for every int8-read conv of a group whose int8-read
// convs are all of stride 1 and dilation 1 (kernels/conv_chain_q8.py:
// tma_layout_q8): every int8 conv of the W8A8 forward's five
// decoder groups and of a `q8_backward` step. The groups with a stride-2
// int8 conv ('enc') or a dilated one ('ctx') stay on conv_group_q8.cu.
//
// It computes what the staged kernel computes, bit for bit:
//   acc[p, co] = sum_k X[p, k] Wq[k, co]   (s32, exact in any order)
// over the channel concat of the conv's int8 reads, then the epilogue
//   v = (float)acc * d[co] + b[co], LeakyReLU(0.1) (act),
//   clip(rint(v), -127, 127) into int8 codes, or bf16 (round to nearest
//   even), every fp32 rounding explicit (no FMA contraction).
//
// Layout. wgmma reads an 8-bit operand only K-major (no transpose bit), so
// a group on this kernel keeps its int8 stripe channels-innermost: one
// [B, H, W, Ctot] tensor (a channels_last [B, Ctot, H, W] view) that holds
// the group inputs (packed densely from channel 0) and then every q8 block,
// each starting on a multiple of 32 channels; Ctot is a multiple of 32. A
// conv reads its blocks as 32-channel chunks of the stripe (those that
// overlap a read block); the packed weight rows of every chunk channel
// that the conv does not read are zeros, so whatever such a channel holds
// (padding, a block that is not read, a block still to be written) adds
// exactly 0. A conv's own block starts on a multiple of 32 past every
// block it reads, so no chunk it loads overlaps what it writes.
//
// Bound on the H100: int8 operations for the decoders' wide convs (K = 9
// Cin up to ~5,200 against 32-128 couts; 1979 dense TOP/s), L2 bytes for
// the rest: each tile reads every weight of its couts, ~2 MB a tile over
// the level-2 group's seven convs against ~1.2 MB of its input rows.
//
// Design:
// - M = output pixels, N = couts (one wgmma n of 8, 16, 32, 64, 96 or 128;
//   tiles of 128 past 128), K = (chunk, tap, channel). A tile is R rows x C
//   columns of one image; its input window, rows y0 - 1 .. y0 + R and
//   columns x0 - 1 .. x0 + C (BW = C + 2 columns), is one TMA box a
//   32-channel chunk, (32, BW, R + 2, 1) with the 32-byte swizzle: it lands
//   as a flat run of 32-byte pixels, TMA's zero fill giving the padding.
//   That is wgmma's K-major 32-byte-swizzle layout (SBO = 8 rows, 256
//   bytes), and a run of 64 pixels starting at ANY pixel is an A operand:
//   wgmma takes the swizzle's XOR from the shared-memory address bits, as
//   TMA does, so a start that is not on the pattern's 256 bytes reads what
//   TMA wrote (its base-offset field stays 0: set to (start >> 7) & 7 the
//   sums came out wrong; both measured on the card, PERF.md). So tap
//   (dy, dx) of the m64 block that starts at window pixel s is the run at
//   s + dy BW + dx: no copy, no shift, no transpose. Two 16-channel boxes
//   without a swizzle (16-byte TMA rows, the no-swizzle layout) took
//   1.75-1.77 ms over the forward's convs against 1.65-1.66.
// - An m64 block m starts at s = m * mstride. Rows mode (C = 64): mstride =
//   BW, block m is output row m. Flat mode (narrow images, C = W): mstride
//   = 64, the blocks run over the flat window and the outputs of its two
//   halo columns are dropped (R BW <= 4 x 64); the last block may read up
//   to 64 pixels past the window, into a slack that only dropped outputs
//   read. kernels/conv_chain_q8.py:tma_q8_tile picks the mode and R. A
//   tile of fewer than 4 blocks repeats its last block's products rather
//   than skip them: ptxas serializes every wgmma of a kernel that issues
//   one under a branch (2.35 ms over the forward's convs against 1.74).
// - One stage of the ring is one 32-channel chunk: its window and the
//   weights of the 9 taps, [tap][K half][N couts][16 channels] (the
//   no-swizzle K-major layout; one bulk copy of 288 N bytes;
//   pack_tma_weights_q8). A ring of 4 stages of up to 52 KB, each with a
//   full (TMA) and an empty mbarrier. Warpgroup 0 holds the producer (one
//   thread, setmaxnreg 40); warpgroups 1 and 2 consume (setmaxnreg 232):
//   m64 blocks 2i + cw, i < 2, of the tile's at most 4, keeping one wgmma
//   group in flight and releasing a stage when its group is done. Every
//   operand comes from shared memory. Blocks are persistent (grid =
//   min(work units, SMs)), so the producer loads the next unit while the
//   consumers store this one.
// - Split K: where the tiles would not fill one wave of the 132 SMs (the
//   coarse levels), the wrapper splits the chunks over `split` blocks
//   (tma_q8_split), which write s32 partial sums to a workspace; a second
//   pass sums them (exact) and applies the epilogue.
// - Epilogue: each thread loads its couts' fp32 vectors at the unit's
//   start, under the products. int8 codes into the stripe's block
//   (channel stride 1): each warp writes its 16 rows' codes into its own
//   rows of shared memory and stores them as 16-byte vectors, a pixel's
//   couts contiguous; bf16 into the NCHW side stripe straight from the
//   accumulators; masked past H, W, the tile and cout. Stored from the
//   accumulators two couts at a time, with the vectors loaded per store,
//   the epilogue took 0.87 of 2.68 ms over the forward (PERF.md).
// What bounds it (PERF.md, tools/conv_tma_ablation.py --q8; NVIDIA H100
// 80GB HBM3, 700 W): the forward's 35 convs take 1.48 ms of device time,
// the level-2 group 0.93 ms, 49.7% of its int8 operations bound; without
// their products they keep 72% of it, without the epilogue 74%: the TMA
// engine's 32-byte rows (a pixel's chunk), every weight of a tile's couts
// read from L2 per tile, and the epilogue, which does not overlap the
// products of the next unit.
#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

using namespace ocf;

constexpr int MAXCHUNK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // the producer's warpgroup + 2 consumer warpgroups
constexpr int MSUB = 2;       // m64 blocks per consumer warpgroup
constexpr int TILE_M = 256;   // window pixels a tile computes at most: 4 m64 blocks
constexpr int KC = 32;        // channels per chunk: one wgmma K, a 32-byte pixel
constexpr int KHALF = 16;     // a weight row's channels: the 16-byte core matrices
constexpr int SLACK = 64;     // window pixels past the window that flat tiles may read
constexpr int MAXBW = 256;    // TMA's largest box dimension
constexpr int NTMAX = 128;
// one stage at most: a window of 416 pixels and 288 x 128 weight bytes;
// stages start on the 32-byte swizzle's 256 bytes
constexpr int STAGE_MAX = 53248;
// a consumer warp's epilogue rows: 16 pixels of NT codes, 16 bytes apart
// past NT (rows of 8 lanes on distinct banks)
constexpr int EBUF = 16 * (NTMAX + 16);
constexpr int SMEM_BYTES = STAGES * STAGE_MAX + 2 * STAGES * 8 + 8 * EBUF + 256;

struct Args {
  int chunk[MAXCHUNK];  // first stripe channel of each K chunk (a multiple of 32)
  int nchunk, H, W, R, C, bw, mstride, mt, tiles_x, tiles_y, ntn, split, units, cout, act,
      out_q8, win;  // win: a stage's window bytes, slack included
  int vec_out;  // int8 codes, channel stride 1, 16-byte pixels and cout: 16-byte stores
  long long out_b, out_c, out_p;  // output strides: batch, channel, pixel (elements)
  void* out;
  const float* dq;
  const float* bq;
  const int8_t* w;  // packed: [ntn][nchunk][9][2][NT][KHALF]
  int* ws;          // split > 1: [split][units / split][TILE_M][NT] s32
};

// d (+)= A[64 x 32] . B[32 x N], both K-major from shared memory
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
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
    y0 = (t / a.tiles_x) * a.R;
    x0 = (t % a.tiles_x) * a.C;
    s0 = sp * a.nchunk / a.split;
    s1 = (sp + 1) * a.nchunk / a.split;
  }
};

// the requantizing epilogue of one sum (the staged kernel's store_out)
__device__ __forceinline__ float requant(int acc, float d, float b, int act) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), d), b);
  return act && !(v >= 0.f) ? __fmul_rn(v, 0.1f) : v;
}

// clip(rint(v), -127, 127): the round to nearest even of the conversion,
// then the clip on the integer (NaN and |v| >= 2^31 convert to INT_MIN /
// INT_MAX and clip as fminf / fmaxf would)
__device__ __forceinline__ int8_t code(float v) {
  return (int8_t)max(-127, min(127, __float2int_rn(v)));
}

// output element offset of window pixel e of unit w, or -1 where e is a
// dropped halo column, past the tile or past the image
__device__ __forceinline__ long long pixel_offset(const Args& a, const Unit& w, int e) {
  const int r = e / a.bw, c = e - r * a.bw;
  const int y = w.y0 + r, x = w.x0 + c;
  if (c >= a.C || r >= a.R || y >= a.H || x >= a.W) return -1;
  return w.b * a.out_b + ((long long)y * a.W + x) * a.out_p;
}

// the epilogue vectors of couts co and co + 1 (zeros past cout)
struct Scale2 {
  float d0, d1, b0, b1;
};

__device__ __forceinline__ Scale2 scales(const Args& a, int co) {
  Scale2 s{0.f, 0.f, 0.f, 0.f};
  if (co < a.cout) {
    s.d0 = a.dq[co];
    s.b0 = a.bq[co];
  }
  if (co + 1 < a.cout) {
    s.d1 = a.dq[co + 1];
    s.b1 = a.bq[co + 1];
  }
  return s;
}

// couts co and co + 1 (requantized values f0, f1) of the pixel at output
// offset o, one at a time
__device__ __forceinline__ void store2(const Args& a, long long o, int co, float f0, float f1) {
  if (co >= a.cout) return;
  const bool both = co + 1 < a.cout;
  if (a.out_q8) {
    int8_t* p = static_cast<int8_t*>(a.out) + o + co * a.out_c;
    if (both && a.out_c == 1) {
      *reinterpret_cast<char2*>(p) = make_char2(code(f0), code(f1));
    } else {
      p[0] = code(f0);
      if (both) p[a.out_c] = code(f1);
    }
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(a.out) + o + co * a.out_c;
    p[0] = __float2bfloat16(f0);
    if (both) p[a.out_c] = __float2bfloat16(f1);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_q8_tma_kernel(const __grid_constant__ CUtensorMap map,
                          const __grid_constant__ Args args) {
  constexpr int NA = NT / 2;            // accumulators per m64 wgmma and thread
  constexpr int WBYTES = 9 * KC * NT;   // a stage's weights
  extern __shared__ unsigned char smem_raw[];
  // the 32-byte swizzle repeats every 256 bytes: stages start on 256
  unsigned char* smem = smem_raw + ((256 - (smem_u32(smem_raw) & 255)) & 255);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_MAX);
  uint64_t* empty = full + STAGES;
  unsigned char* ebuf = reinterpret_cast<unsigned char*>(empty + STAGES);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // producer: one thread keeps the ring full
      const unsigned box = KC * args.bw * (args.R + 2);
      int it = 0;
      for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
        const Unit w(args, u);
        for (int st = w.s0; st < w.s1; ++st, ++it) {
          const int s = it % STAGES, c0 = args.chunk[st];
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = smem + s * STAGE_MAX;
          mbar_expect_tx(&full[s], box + WBYTES);
          tma_load_4d(sa, &map, &full[s], c0, w.x0 - 1, w.y0 - 1, w.b);
          bulk_load(sa + args.win,
                    args.w + ((long long)w.nt * args.nchunk + st) * WBYTES, WBYTES, &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    // consumers: m64 blocks m = 2 i + cw of the tile
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int d[MSUB][NA];
    int it = 0;
    for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
      const Unit w(args, u);
      // the epilogue's vectors of couts nt NT + 8j + 2 (lane % 4) + {0, 1}
      Scale2 scl[NT / 8];
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) scl[j] = scales(args, w.nt * NT + 8 * j + 2 * (lane % 4));
      for (int st = w.s0; st < w.s1; ++st, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t sa = smem_u32(smem + s * STAGE_MAX), sw = sa + args.win;
#pragma unroll
        for (int i = 0; i < MSUB; ++i) fence_acc(d[i]);
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            // B: tap (dy, dx)'s two K halves of NT couts (no swizzle);
            // A: 64 window pixels from m mstride + dy BW + dx (32-byte
            // swizzle)
            const uint64_t db = smem_desc(sw + (3 * dy + dx) * KC * NT, KHALF * NT, 128, 0);
#pragma unroll
            for (int i = 0; i < MSUB; ++i) {
              // a block past the tile's mt repeats block mt - 1, unread
              const int m = min(2 * i + cw, args.mt - 1);
              wgmma_s8<NT>(d[i],
                           smem_desc(sa + KC * (m * args.mstride + dy * args.bw + dx), 16,
                                     8 * KC, 3),
                           db, st > w.s0 || dy > 0 || dx > 0);
            }
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

      // d[i][4j + {0, 1}]: row warp 16 + lane / 4 of block m, couts
      // 8j + 2 (lane % 4) + {0, 1}; d[i][4j + {2, 3}] the row 8 on. Codes
      // into the stripe go through the warp's rows in shared memory and
      // out as 16-byte vectors, a pixel's couts at a time.
      unsigned char* buf = ebuf + (threadIdx.x / 32 - 4) * EBUF;
      const int q = lane % 4, r0 = warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < MSUB; ++i) {
        const int m = 2 * i + cw;
        if (m >= args.mt) continue;
        if (args.ws != nullptr) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int* p = args.ws +
                     ((long long)(w.sp * (args.units / args.split) + w.un) * TILE_M + m * 64 +
                      r0 + 8 * h) * NT + 2 * q;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
              *reinterpret_cast<int2*>(p + 8 * j) = make_int2(d[i][4 * j + 2 * h],
                                                              d[i][4 * j + 2 * h + 1]);
          }
          continue;
        }
        long long o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          o[h] = args.vec_out ? 0 : pixel_offset(args, w, m * args.mstride + r0 + 8 * h);
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int co = w.nt * NT + 8 * j + 2 * q;
          const Scale2 sc = scl[j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float f0 = requant(d[i][4 * j + 2 * h], sc.d0, sc.b0, args.act);
            const float f1 = requant(d[i][4 * j + 2 * h + 1], sc.d1, sc.b1, args.act);
            if (args.vec_out)
              *reinterpret_cast<char2*>(buf + (lane / 4 + 8 * h) * (NT + 16) + 8 * j + 2 * q) =
                  make_char2(code(f0), code(f1));
            else if (o[h] >= 0)
              store2(args, o[h], co, f0, f1);
          }
        }
        if (args.vec_out) {
          __syncwarp();
          // 16 rows of NT / 16 vectors
          for (int c = lane; c < NT; c += 32) {
            const int row = c / (NT / 16), part = c % (NT / 16);
            const long long op = pixel_offset(args, w, m * args.mstride + warp * 16 + row);
            const int co = w.nt * NT + 16 * part;
            if (op >= 0 && co < args.cout)
              *reinterpret_cast<uint4*>(static_cast<int8_t*>(args.out) + op + co) =
                  *reinterpret_cast<const uint4*>(buf + row * (NT + 16) + 16 * part);
          }
          __syncwarp();
        }
      }
    }
  }
}

// the split-K pass: one thread per (unit, window pixel, cout pair) sums the
// splits' partials (exact in s32), then the epilogue
__global__ void __launch_bounds__(256) split_reduce_kernel(const __grid_constant__ Args args,
                                                           int nt_width) {
  const int pairs = nt_width / 2;
  const long long per_split = (long long)(args.units / args.split) * TILE_M * nt_width;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_split / 2) return;
  const int col = 2 * (int)(idx % pairs), m = (int)(idx / pairs % TILE_M);
  if (m / 64 >= args.mt) return;
  const Unit w(args, (int)(idx / ((long long)pairs * TILE_M)) * args.split);
  const long long o = pixel_offset(args, w, (m / 64) * args.mstride + m % 64);
  if (o < 0) return;
  const long long at = 2 * idx;
  int v0 = args.ws[at], v1 = args.ws[at + 1];
  for (int sp = 1; sp < args.split; ++sp) {
    v0 += args.ws[sp * per_split + at];
    v1 += args.ws[sp * per_split + at + 1];
  }
  const int co = w.nt * nt_width + col;
  const Scale2 sc = scales(args, co);
  store2(args, o, co, requant(v0, sc.d0, sc.b0, args.act), requant(v1, sc.d1, sc.b1, args.act));
}

template <int NT>
int launch(const CUtensorMap& map, const Args& args, cudaStream_t s) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      conv3x3_q8_tma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (attr != 0) return attr;
  if (args.win + 9 * KC * NT > STAGE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  conv3x3_q8_tma_kernel<NT>
      <<<args.units < sms ? args.units : sms, THREADS, SMEM_BYTES, s>>>(map, args);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || args.split == 1) return err;
  const long long n = (long long)(args.units / args.split) * TILE_M * NT / 2;
  split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(args, NT);
  return static_cast<int>(cudaGetLastError());
}

// Every pixel of an R x C tile (window pixel e = r BW + c) lies in exactly
// one m64 block (mstride >= 64) of the first mt, and every block's taps
// stay inside the window and its slack.
bool tile_ok(int R, int C, int mstride, int mt) {
  const int bw = C + 2;
  if (R < 1 || C < 1 || bw > MAXBW || R + 2 > MAXBW || mt < 1 || mt > 2 * MSUB ||
      mstride < 64 || (long long)(mt - 1) * mstride + 63 + 2 * bw + 2 >=
                          (long long)(R + 2) * bw + SLACK)
    return false;
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < C; ++c) {
      const int e = r * bw + c;
      if (e % mstride >= 64 || e / mstride >= mt) return false;
    }
  return true;
}

}  // namespace

// One conv on the int8 stripe `stripe` ([B, H, W, ctot] int8, ctot a
// multiple of 32, 16-byte aligned): chunks[0 .. nchunk), the first stripe
// channel of each 32-channel K chunk (multiples of 32), in the order of
// the packed weight `w` ([ntn][nchunk][9][2][nt][KHALF] int8, nt couts per
// tile: 8, 16, 32, 64, 96 or 128; kernels/conv_chain_q8.py:
// pack_tma_weights_q8). dq, bq: fp32 [cout]. Writes cout channels at `out`
// with element strides out_b (batch), out_c (channel), out_p (pixel; rows
// of W pixels): int8 codes when out_q8, else bf16. The tile: tile_r rows x
// tile_c columns, its m64 blocks mstride window pixels apart, mt of them
// (kernels/conv_chain_q8.py:tma_q8_tile). split > 1 splits K over blocks,
// with `ws` an s32 workspace of split * units * 256 * nt (units = B *
// tiles * ntn). Returns the first CUDA error of the encode and the launches.
extern "C" int ocf_conv3x3_q8_tma(const void* stripe, int B, int H, int W, int ctot,
                                  const int* chunks, int nchunk, const void* w, int nt, int ntn,
                                  const void* dq, const void* bq, void* out, long long out_b,
                                  long long out_c, long long out_p, int out_q8, int cout,
                                  int act, int tile_r, int tile_c, int mstride, int mt,
                                  int split, void* ws, void* stream) {
  if (B < 1 || H < 1 || W < 1 || ctot < KC || ctot % KC || nchunk < 1 || nchunk > MAXCHUNK ||
      ntn < 1 || cout < 1 || cout > nt * ntn || split < 1 || split > nchunk ||
      (split > 1) != (ws != nullptr) || out_p < 1 || !tile_ok(tile_r, tile_c, mstride, mt) ||
      reinterpret_cast<uintptr_t>(stripe) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  for (int i = 0; i < MAXCHUNK; ++i) {
    args.chunk[i] = i < nchunk ? chunks[i] : 0;
    if (i < nchunk && (chunks[i] % KC || chunks[i] < 0 || chunks[i] + KC > ctot))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bw = tile_c + 2;
  ocf::MapKey k;
  std::memset(&k, 0, sizeof k);  // the padding too: keys compare as bytes
  k.ptr = stripe;
  k.rank = 4;
  k.dtype = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)ctot, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ctot, (cuuint64_t)W * ctot,
                                 (cuuint64_t)H * W * ctot};
  const cuuint32_t box[4] = {KC, (cuuint32_t)bw, (cuuint32_t)(tile_r + 2), 1};
  std::memcpy(k.dims, dims, sizeof dims);
  std::memcpy(k.strides, strides, sizeof strides);
  std::memcpy(k.box, box, sizeof box);
  CUtensorMap map;
  const int err = ocf::encode_cached(&map, k);
  if (err != 0) return err;
  args.nchunk = nchunk;
  args.H = H;
  args.W = W;
  args.R = tile_r;
  args.C = tile_c;
  args.bw = bw;
  args.mstride = mstride;
  args.mt = mt;
  args.tiles_x = (W + tile_c - 1) / tile_c;
  args.tiles_y = (H + tile_r - 1) / tile_r;
  args.ntn = ntn;
  args.split = split;
  args.units = B * args.tiles_y * args.tiles_x * ntn * split;
  args.cout = cout;
  args.act = act;
  args.out_q8 = out_q8;
  args.vec_out = out_q8 && out_c == 1 && out_p % 16 == 0 && nt % 16 == 0 && cout % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  args.win = (KC * (bw * (tile_r + 2) + SLACK) + 255) / 256 * 256;
  args.out_b = out_b;
  args.out_c = out_c;
  args.out_p = out_p;
  args.out = out;
  args.dq = static_cast<const float*>(dq);
  args.bq = static_cast<const float*>(bq);
  args.w = static_cast<const int8_t*>(w);
  args.ws = static_cast<int*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 8: return launch<8>(map, args, s);
    case 16: return launch<16>(map, args, s);
    case 32: return launch<32>(map, args, s);
    case 64: return launch<64>(map, args, s);
    case 96: return launch<96>(map, args, s);
    case 128: return launch<128>(map, args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the tensor maps encoded so far (not found in the cache)
extern "C" long long ocf_q8_tma_map_encodes() { return ocf::map_encodes(); }
