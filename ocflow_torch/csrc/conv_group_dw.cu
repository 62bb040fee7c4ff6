// The weight and bias gradients of one bf16 3x3 convolution of stride 1
// and dilation 1 of a conv group, for Hopper (sm_90a): a TMA ring, shift
// warps, wgmma consumers, split K and a deterministic second pass.
//
// Replaces the dW / db half of `conv_group_diff`'s backward, the XLA
// adjoint `_diff_bwd` of ocflow_tpu/ops/pallas/conv_chain_kernel.py:1258
// (one conv VJP per read block there); conv_group_tma.cu's adjoint
// epilogue takes the dX half. For conv j with output cotangent g (the
// masked cotangent of the gradient stripe) and reads X (the group's
// inputs and stripe blocks):
//   dW[co, c, dy, dx] = sum_{b, y, x} g[b, co, y, x] X[b, c, y + dy - 1, x + dx - 1]
//   db[co]            = sum_{b, y, x} g[b, co, y, x]
// a GEMM per tap with M = the read channels, N = cout and K = the B H W
// pixels (229,376 at the 448x1024 level-2 group).
//
// Bound on the H100: operations, as many as the conv's forward (0.85 ms
// for the 448x1024 level-2 group at 989 TFLOP/s); the bytes are the
// reads and g, each once. What the design does about it:
// - In NCHW both operands have the pixels contiguous, so both come
//   K-major through TMA boxes with the 128-byte swizzle and no transpose
//   bit: a line is 64 pixels (128 bytes) of one channel and one row, the
//   canonical K-major layout (8-line atoms of 1 KB, SBO 1 KB), K stepped by
//   32 bytes inside the swizzle span.
// - A K step is the 64 pixels x0 .. x0 + 63 of output row y of one image:
//   it reads X rows y - 1 .. y + 1 and g row y. The ring holds X rows, not
//   steps: a slot is one X row (64 pixels of 64 channels of one read
//   segment) at the columns of dx = 1, an 8-pixel strip on each side, the
//   windows of dx = 0 and 2 that the shift warps (shared with
//   conv_group_tma.cu, hopper.cuh:shift_lines) write beside it, since a TMA
//   box cannot start at x0 - 1, and the g row of the step whose last X row
//   it is. Consecutive rows of one image and column tile (a run) share
//   their X rows: a step loads one new X row (two more at a run's start),
//   and its dy taps read the three newest slots. TMA's zero fill gives the
//   padding, the channels past a segment's end and the pixels past W (a 16
//   or 32 wide level computes zeros past its edge).
// - Two consumer warpgroups share the X windows and take NW couts each
//   (NW = 8, 16 or 32 by cout): nine m64nNW accumulators a thread, 9 NW /
//   2 fp32 registers (144 at NW = 32). Couts past 2 NW go to other blocks.
// - Blocks: (64-channel chunk m, cout tile n, K split sp). The split
//   (kernels/conv_chain.py:dw_split) fills one wave of the 132 SMs; each
//   block writes its fp32 partial sums [2 NW][64][9] to a workspace, and
//   the blocks of chunk 0 also the partial sums of g over their pixels
//   (db). A second pass sums the partials in split order (no float
//   atomics: every run gives the same bits) and stores dW in OIHW over the
//   reads and db, both bf16.
// The tensor maps are encoded on the host and kept for calls with the
// same addresses and shapes (hopper.cuh:encode_cached).

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ocf;

constexpr int MAXSEG = 8;
constexpr int MAXCHUNK = 64;
constexpr int SLOTS = 6;      // X rows in the ring: 3 read by a step, 3 ahead
constexpr int THREADS = 384;  // producer and shift warps + 2 consumer warpgroups
constexpr int SHIFTERS = 96;  // warps 1-3
constexpr int PIX = 64;       // pixels a K step: one line of 128 bytes
constexpr int MC = 64;        // read channels a chunk: one wgmma M
constexpr int LINE = 2 * PIX;
constexpr int BOX = MC * LINE;  // one window of one row: 8 KB
constexpr int STRIP = MC * 16;  // 8 pixels of each line
constexpr int STRIPS = 3 * BOX;
constexpr int GOFF = STRIPS + 2 * STRIP;  // 26 KB: on 1 KB
constexpr int SLOT = GOFF + 64 * LINE;    // g: at most 64 couts
constexpr int SMEM_BYTES = SLOTS * SLOT + 3 * SLOTS * 8 + 1024;
constexpr int TAPS = 9;

struct Maps {
  CUtensorMap seg[MAXSEG];    // per read segment: (W, C_seg, H, B), boxes (64, 64, 1, 1)
  CUtensorMap strip[MAXSEG];  // the same tensor, boxes (8, 64, 1, 1), no swizzle
  CUtensorMap g;              // the cotangent: (W, cout, H, B), boxes (64, 2 NW, 1, 1)
};

struct Args {
  int chunk[MAXCHUNK];    // segment | first channel << 3
  int seg_off[MAXSEG];    // first read channel of each segment
  int seg_chunk[MAXSEG];  // first chunk of each segment
  int nseg, nchunk, H, W, tiles_x, ksteps, ntn, split, nmn, cout, cin;
  float* ws;     // [nchunk * ntn][split][2 NW][64][9] fp32
  float* ws_db;  // [ntn][split][2 NW] fp32
  __nv_bfloat16* dw;  // [cout][cin][3][3]
  __nv_bfloat16* db;  // [cout]
};

// d (+)= A[64 x 16] . B[16 x N]: both K-major (no transpose)
template <int N>
__device__ __forceinline__ void wgmma_kk(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_kk<8>(float (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_kk<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_kk<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// K step s of the unit: output row y of image b at tile columns x0; a
// run of rows starts at the unit's first step and at every row 0
struct Step {
  int b, y, x0;
  __device__ Step(const Args& a, int s) {
    y = s % a.H;
    const int r = s / a.H;
    x0 = (r % a.tiles_x) * PIX;
    b = r / a.tiles_x;
  }
};

__device__ __forceinline__ bool run_start(const Args& a, int s, int s0) {
  return s == s0 || s % a.H == 0;
}

template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_dw_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args args) {
  constexpr int NA = NW / 2;  // accumulators per tap and thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SLOTS * SLOT);
  uint64_t* ready = full + SLOTS;
  uint64_t* empty = ready + SLOTS;
  // the unit: the blocks running together share a K range (sp), so their
  // X and g boxes meet in L2
  const int sp = blockIdx.x / args.nmn, mn = blockIdx.x % args.nmn;
  const int m = mn / args.ntn, n = mn % args.ntn;
  const int s0 = (int)((long long)sp * args.ksteps / args.split);
  const int s1 = (int)((long long)(sp + 1) * args.ksteps / args.split);
  const int seg = args.chunk[m] & 7, c0 = args.chunk[m] >> 3;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SHIFTERS);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<104>();
    if (threadIdx.x == 0) {
      // producer: X row `row` into slot c % SLOTS, with g row `gy` (or none)
      int c = 0;
      auto load = [&](const Step& k, int row, int gy) {
        const int s = c % SLOTS;
        mbar_wait(&empty[s], ((c / SLOTS) & 1) ^ 1);
        unsigned char* sa = smem + s * SLOT;
        mbar_expect_tx(&full[s], BOX + 2 * STRIP + (gy >= 0 ? 2 * NW * LINE : 0));
        tma_load_4d(sa + BOX, &maps.seg[seg], &full[s], k.x0, c0, row, k.b);
        tma_load_4d(sa + STRIPS, &maps.strip[seg], &full[s], k.x0 - 8, c0, row, k.b);
        tma_load_4d(sa + STRIPS + STRIP, &maps.strip[seg], &full[s], k.x0 + PIX, c0, row, k.b);
        if (gy >= 0) tma_load_4d(sa + GOFF, &maps.g, &full[s], k.x0, n * 2 * NW, gy, k.b);
        ++c;
      };
      for (int st = s0; st < s1; ++st) {
        const Step k(args, st);
        if (run_start(args, st, s0)) {
          load(k, k.y - 1, -1);
          load(k, k.y, -1);
        }
        load(k, k.y + 1, k.y);
      }
    } else if (threadIdx.x >= 32) {
      // shift warps: each slot's dx = 0 and 2 windows once its row has landed
      const int t = threadIdx.x - 32;
      int c = 0;
      for (int st = s0; st < s1; ++st) {
        for (int r = run_start(args, st, s0) ? 3 : 1; r > 0; --r, ++c) {
          const int s = c % SLOTS;
          mbar_wait(&full[s], (c / SLOTS) & 1);
          unsigned char* sa = smem + s * SLOT;
          shift_lines<SHIFTERS>(sa, BOX, sa + STRIPS, STRIP, MC, PIX, t);
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {
    // consumers: couts n 2 NW + cw NW .. + NW - 1
    setmaxnreg_inc<200>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // db: the 16-byte chunks of this warpgroup's g lines, PER a thread,
    // TPL threads a line
    constexpr int CH = NW * 8, PER = CH > 128 ? CH / 128 : 1, TPL = 8 / PER;
    const bool sums = m == 0 && t < CH / PER;
    float dsum = 0.f;
    float d[TAPS][NA];
    auto landed = [&](int c) {
      mbar_wait(&full[c % SLOTS], (c / SLOTS) & 1);  // the TMA bytes, then the shifts
      mbar_wait(&ready[c % SLOTS], (c / SLOTS) & 1);
    };
    auto release = [&](int c) {
      if (lane == 0) mbar_arrive(&empty[c % SLOTS]);
    };
    int c = 0;  // X rows consumed
    for (int st = s0; st < s1; ++st) {
      const bool start = run_start(args, st, s0);
      if (start) {
        landed(c);
        landed(c + 1);
        c += 2;
      }
      landed(c);
      // this step: X rows c - 2 .. c (dy = 0 .. 2), g in slot c
      const uint32_t sg = smem_u32(smem + (c % SLOTS) * SLOT) + GOFF + cw * NW * LINE;
#pragma unroll
      for (int i = 0; i < TAPS; ++i) fence_acc(d[i]);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t sx = smem_u32(smem + ((c - 2 + dy) % SLOTS) * SLOT);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int k = 0; k < PIX / 16; ++k)
            wgmma_kk<NW>(d[3 * dy + dx], smem_desc(sx + dx * BOX + 32 * k, 16, 1024, 1),
                         smem_desc(sg + 32 * k, 16, 1024, 1), st > s0 || k > 0);
      }
      wgmma_commit();
      if (sums) {
        const unsigned char* gl = smem + (c % SLOTS) * SLOT + GOFF +
                                  (cw * NW + t / TPL) * LINE + (t % TPL) * PER * 16;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(gl + 16 * i);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            dsum += f.x + f.y;
          }
        }
      }
      wgmma_wait<1>();  // the previous step's products are done
#pragma unroll
      for (int i = 0; i < TAPS; ++i) fence_acc(d[i]);
      if (!start) release(c - 3);  // the previous step's oldest row
      ++c;
      if (st + 1 == s1 || run_start(args, st + 1, s0)) {
        // the run's last step: its three rows
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < TAPS; ++i) fence_acc(d[i]);
        release(c - 3);
        release(c - 2);
        release(c - 1);
      }
    }
    wgmma_wait<0>();  // (every run ended in one: for the compiler)
#pragma unroll
    for (int i = 0; i < TAPS; ++i) fence_acc(d[i]);

    // d[tap][4j + {0, 1}]: read channel warp 16 + lane / 4, couts 8j +
    // 2 (lane % 4) + {0, 1} of this warpgroup's; d[tap][4j + {2, 3}] the
    // channel 8 on
    float* p = args.ws + ((long long)mn * args.split + sp) * (2 * NW) * MC * TAPS;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = warp * 16 + lane / 4 + 8 * h;
          const int col = cw * NW + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap)
            p[(col * MC + row) * TAPS + tap] = d[tap][4 * j + 2 * h + e];
        }
    // every lane takes part in the shuffles; the lanes without a line add 0
#pragma unroll
    for (int o = 1; o < TPL; o *= 2) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (sums && t % TPL == 0)
      args.ws_db[((long long)n * args.split + sp) * (2 * NW) + cw * NW + t / TPL] = dsum;
  }
}

// the second pass: one thread per dW element (OIHW over the reads), then
// one per db element, each summing its partials in split order
__global__ void __launch_bounds__(256) dw_reduce_kernel(const __grid_constant__ Args args,
                                                        int nw2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)args.cout * args.cin * TAPS;
  if (idx < total) {
    const int tap = (int)(idx % TAPS), ci = (int)(idx / TAPS % args.cin);
    const int co = (int)(idx / ((long long)TAPS * args.cin));
    int s = 0;
    while (s + 1 < args.nseg && ci >= args.seg_off[s + 1]) ++s;
    const int c = ci - args.seg_off[s];
    const int mn = (args.seg_chunk[s] + c / MC) * args.ntn + co / nw2;
    const float* p = args.ws + (long long)mn * args.split * nw2 * MC * TAPS +
                     ((long long)(co % nw2) * MC + c % MC) * TAPS + tap;
    float v = 0.f;
    for (int sp = 0; sp < args.split; ++sp) v += p[(long long)sp * nw2 * MC * TAPS];
    args.dw[idx] = __float2bfloat16(v);
  } else if (idx < total + args.cout) {
    const int co = (int)(idx - total);
    const float* p = args.ws_db + (long long)(co / nw2) * args.split * nw2 + co % nw2;
    float v = 0.f;
    for (int sp = 0; sp < args.split; ++sp) v += p[sp * nw2];
    args.db[co] = __float2bfloat16(v);
  }
}

// a bf16 [B, C, H, W] tensor (plane, row and batch strides) as a map of
// dims (W, C, H, B) with boxes (box0, box1, box2, 1)
int encode(CUtensorMap* map, const void* ptr, int W, int C, int H, int B, long long bstride,
           int box0, int box1, int box2, int swizzle) {
  MapKey k;
  std::memset(&k, 0, sizeof k);  // the padding too: keys compare as bytes
  k.ptr = ptr;
  k.rank = 4;
  k.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)H * W * 2, (cuuint64_t)W * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  std::memcpy(k.dims, dims, sizeof dims);
  std::memcpy(k.strides, strides, sizeof strides);
  std::memcpy(k.box, box, sizeof box);
  k.swizzle = swizzle;
  return encode_cached(map, k);
}

template <int NW>
int launch(const Maps& maps, const Args& args, cudaStream_t s) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      conv3x3_dw_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (attr != 0) return attr;
  conv3x3_dw_kernel<NW><<<args.nmn * args.split, THREADS, SMEM_BYTES, s>>>(maps, args);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = (long long)args.cout * args.cin * TAPS + args.cout;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(args, 2 * NW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dW and db of one conv: X is `nseg` read segments (ptrs[i] at batch
// stride bstrides[i] elements, chans[i] channels, each [*, H, W] channel
// contiguous, 16-byte aligned, W a multiple of 8), in read order;
// chunks[0 .. nchunk): 64-channel chunks (segment | first channel << 3),
// each segment's in order. g: the cotangent [B, cout, H, W] at batch
// stride g_bstride. nw: couts a consumer warpgroup takes (8, 16, 32),
// ceil(cout / 2 nw) tiles. split: K splits (kernels/conv_chain.py:
// dw_split); ws: nchunk * tiles * split * 2 nw * 576 floats, ws_db: tiles
// * split * 2 nw floats. Writes dw [cout][cin][3][3] (cin = sum(chans)) and
// db [cout], both bf16. Returns the first CUDA error of the encodes and
// the launches.
extern "C" int ocf_conv3x3_dw(int nseg, void** ptrs, const long long* bstrides,
                              const int* chans, int B, int H, int W, const int* chunks,
                              int nchunk, const void* g, long long g_bstride, int cout, int nw,
                              int split, void* ws, void* ws_db, void* dw, void* db,
                              void* stream) {
  const int ntn = nw > 0 ? (cout + 2 * nw - 1) / (2 * nw) : 0;
  const int ksteps = B * H * ((W + PIX - 1) / PIX);
  if (nseg < 1 || nseg > MAXSEG || nchunk < 1 || nchunk > MAXCHUNK || B < 1 || H < 1 ||
      W < 8 || W % 8 || cout < 1 || (nw != 8 && nw != 16 && nw != 32) || split < 1 ||
      split > ksteps || ws == nullptr || ws_db == nullptr ||
      reinterpret_cast<uintptr_t>(g) % 16 || g_bstride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  Args args;
  int cin = 0;
  for (int i = 0; i < nseg; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || bstrides[i] % 8 || chans[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    int err = encode(&maps.seg[i], ptrs[i], W, chans[i], H, B, bstrides[i], PIX, MC, 1,
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = encode(&maps.strip[i], ptrs[i], W, chans[i], H, B, bstrides[i], 8, MC, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
    args.seg_off[i] = cin;
    args.seg_chunk[i] = -1;
    cin += chans[i];
  }
  for (int i = nseg; i < MAXSEG; ++i) {
    maps.seg[i] = maps.seg[0];
    maps.strip[i] = maps.strip[0];
    args.seg_off[i] = cin;
    args.seg_chunk[i] = 0;
  }
  // the chunks: each segment's in order, 64 channels apart, all of them
  for (int i = 0; i < MAXCHUNK; ++i) {
    args.chunk[i] = i < nchunk ? chunks[i] : 0;
    if (i >= nchunk) continue;
    const int s = chunks[i] & 7, c0 = chunks[i] >> 3;
    if (s >= nseg || c0 >= chans[s] || c0 % MC) return static_cast<int>(cudaErrorInvalidValue);
    if (c0 == 0) args.seg_chunk[s] = i;
    else if (i == 0 || chunks[i - 1] != (s | (c0 - MC) << 3))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < nseg; ++i)
    if (args.seg_chunk[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = encode(&maps.g, g, W, cout, H, B, g_bstride, PIX, 2 * nw, 1,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  args.nseg = nseg;
  args.nchunk = nchunk;
  args.H = H;
  args.W = W;
  args.tiles_x = (W + PIX - 1) / PIX;
  args.ksteps = ksteps;
  args.ntn = ntn;
  args.split = split;
  args.nmn = nchunk * ntn;
  args.cout = cout;
  args.cin = cin;
  args.ws = static_cast<float*>(ws);
  args.ws_db = static_cast<float*>(ws_db);
  args.dw = static_cast<__nv_bfloat16*>(dw);
  args.db = static_cast<__nv_bfloat16*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 8: return launch<8>(maps, args, s);
    case 16: return launch<16>(maps, args, s);
    default: return launch<32>(maps, args, s);
  }
}
