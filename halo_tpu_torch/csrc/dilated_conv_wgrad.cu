// Kernel C's weight gradient: dk of the dense 3x3 conv, stride 1, padding
// d, dilation d.
//
// Replaces the VJP's dk of the TPU kernel dilated_conv3x3
// (halo_tpu/ops/pallas_conv.py:180-182, _vjp_bwd: nine float32
// contractions through halo_tpu/ops/conv_grads.py:19, then .astype of the
// weight's dtype). For a channels-last input x (B, H, W, C) and cotangent
// g (B, H, W, Co):
//   dk[o, c, i, j] = sum_{b,h,w} x[b, h + (i-1)d, w + (j-1)d, c] g[b,h,w,o]
// where reads outside the image are zeros, summed in float32 and rounded
// once to bf16, written in the (Co, C, 3, 3) layout of the nn.Conv2d
// weight.
//
// What bounds it on an H100. In principle operations: each tap is a GEMM
// with M = C, N = Co and a long K = B*H*W, 2*9*C*Co*B*H*W FLOP (34.0
// GFLOP at layer3 of the R101 trunk, B = 2, 90x160, C = Co = 256: 0.034
// ms at 989 TFLOP/s; 0.137 ms for 512 channels). In practice a block's
// pixel step, bound by three things of the same size: the bytes it
// brings from L2 into shared memory (whatever the number of blocks: a
// per-SM rate, not L2's), the tensor cores, and the step's handshake. The
// output is small (9 x 256 x 256) and K is long, so the card is filled by
// splitting K. tools/wgrad_probe.py times each phase and each bound.
//
// Design: TMA + wgmma, warp-specialised like the forward kernel.
//  - A tile is the three taps of one row of the 3x3 (i, j = 0, 1, 2) for
//    64 input x 128 output channels: three consumer warpgroups, one a tap
//    (wgmma m64n128k16, float32 accumulators in registers). The three
//    taps read the same cotangent g and x shifted by d pixel columns, so
//    one x box serves all three: a step of 64 pixels brings 16 KB of g and
//    10 KB of x (at d = 2 or 4) for 3.15 MFLOP, 118 FLOP a byte (one tap
//    a tile of 128 x 256 channels brought 48 KB for 4.19 MFLOP, 85).
//  - The boxes are laid with a pixel column's rows together (tensor maps
//    with dims C, H, W, B): a step is hs = 8 / gcd(d, 8) rows by 64 / hs
//    columns (d = 2: 4 x 16; d = 4: 2 x 32), so a shift of d columns is
//    hs * d 128-byte rows, a whole number of 1024-byte swizzle atoms, and
//    tap j's wgmma operand starts j * d * hs rows into the x box of (64 /
//    hs + 2d) columns. Past lcm(d, 8) = 64 three boxes of 2 x 32 pixels
//    are cheaper. TMA's zero fill does the padding margin, the ragged H/W
//    edges and channels past C. A box lands as 128-byte rows, one pixel a
//    row, 128B-swizzled: the MN-major layout that wgmma reads for bf16
//    through its transpose bits (sw128_mn_desc).
//  - One producer thread keeps a ring of stages (8 of 26 KB at d = 2 or
//    4) in flight against full/empty mbarriers; setmaxnreg moves registers
//    to the consumers. No integer division runs a step: the stage, its
//    parity and the step's (b, row, column) advance by additions. A
//    division by a runtime shape on the path to a wait or a load costs
//    about half a step (the probe's `divide` variant puts them back).
//  - The tensor cores accumulate in float32 with less care than a
//    rounded add: over runs of up to 128 steps (88 at layer3) the error
//    reached 33 bf16 steps beyond 1e-5 of max|dk| on an element whose
//    terms cancel, where float32 sums rounded to nearest stayed within it
//    (tools/wgrad_probe.py --step0). So a run is at most kFlush = 8 steps
//    (512 pixels' products), and each thread adds the runs into float32
//    sums in registers, rounded to nearest: in 40 step-0 captures runs of
//    8 stayed within half a bf16 step, as runs of 1 did, at 4% more time
//    than runs of 128 (runs of 1: 34-45% more).
//  - The split is the wrapper's plan (ops/dilated_conv.py:wgrad_plan):
//    each tile's KT pixel steps are dealt into P residues (kt mod P) and
//    the T*P (tile, residue) units cut, tile by tile, into G <= SMs equal
//    contiguous ranges, one a block; a block walks its residues of a tile
//    in increasing kt. At layer3 P = 21: 24 tiles x 460 steps on all 132
//    SMs, 88 steps at most (83.6 on average); at 512 channels 96 tiles,
//    336 at most (334.5), two to three blocks a tile.
//  - No second pass over a workspace: the partials of a tile are summed
//    inside this kernel in a fixed order. A block that holds a whole tile
//    writes it from its registers. Otherwise each block that shares the
//    tile stores its float32 partial (96 KB) to slot block + tile of the
//    workspace and arrives on the tile's counter; the blocks whose range
//    ends in the tile (its finishers: all of its blocks but, maybe, the
//    last, which goes on to its next tile) wait for every partial, then
//    each sums its share of the tile over the partials in block order
//    and rounds to bf16. Two calls give the same bits. The sums go to a
//    bf16 (9, C, Co) staging area with whole-sector stores; after a grid
//    barrier every block turns 32 x 32 chunks of it into (Co, C, 3, 3)
//    rows through shared memory (a tap a tile, written straight to dk,
//    would be 2-byte stores 18 bytes apart). The counters reset
//    themselves (the last arrival zeroes the count and advances the
//    generation the waiters watch), so no memset runs a call; the wrapper
//    keeps one counter buffer a stream. The waits need every block
//    resident: G <= SMs at one block an SM (214 KB of shared memory).

#include "dilated_conv.cuh"

namespace {

constexpr int kPK = 64;                // pixels a step: the K of a step
constexpr int kTM = 64;                // input channels a tile: one box
constexpr int kTN = 128;               // output channels a tile: two boxes
constexpr int kTaps = 3;               // a tile: the three taps of a row
constexpr int kBoxBytes = 64 * kPK * 2;          // 64 channels x 64 pixels
constexpr int kGBytes = (kTN / 64) * kBoxBytes;  // 16 KB
constexpr int kRingBytes = 208 * 1024;
constexpr int kMaxStages = 8;
constexpr int kBarOffset = kRingBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kMaxStages * 8 + 1024;  // + align
constexpr int kThreads = 512;          // producer warpgroup + 3 consumers
constexpr int kConsumers = 384;
constexpr int kAlign = 32;             // the C and Co rule (supports())
constexpr int kPartial = kTaps * kTM * kTN;  // floats of a partial tile
constexpr int kQuads = kPartial / 4;
constexpr int kBatch = 4;              // float4s a thread sums at once
constexpr int kFlush = 8;              // the longest tensor-core run, steps
constexpr int kChunk = 32;             // the transpose: 32 x 32 (m, o)
constexpr int kChunkPitch = kChunk * 9 + 8;  // bf16: 16-byte rows

static_assert(kQuads % kConsumers == 0, "float4 reduce shares");
static_assert(kChunk * kChunkPitch * 2 <= kRingBytes, "transpose in the ring");
static_assert(kRingBytes >= 2 * (kGBytes + kTaps * kBoxBytes),
              "two stages of the largest step");

// The block whose contiguous range of the U units holds unit u, when G
// blocks take [b*U/G, (b+1)*U/G).
__device__ __forceinline__ int block_of(long long u, long long U, int G) {
  return static_cast<int>(((u + 1) * G - 1) / U);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// s = (s + a) + b, component by component: the partials' fixed order.
__device__ __forceinline__ void add4(float4& s, const float4& a,
                                     const float4& b) {
  s.x = (s.x + a.x) + b.x;
  s.y = (s.y + a.y) + b.y;
  s.z = (s.z + a.z) + b.z;
  s.w = (s.w + a.w) + b.w;
}

// The three consumer warpgroups only (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A consumer thread's 64 accumulators to its rows of a partial tile (row
// stride kTN floats); each store writes whole 32-byte sectors.
__device__ __forceinline__ void store_run(float* mine,
                                          const float (&acc)[64]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    __stcg(reinterpret_cast<float2*>(mine + 8 * q),
           make_float2(acc[4 * q], acc[4 * q + 1]));
    __stcg(reinterpret_cast<float2*>(mine + 8 * kTN + 8 * q),
           make_float2(acc[4 * q + 2], acc[4 * q + 3]));
  }
}

// Arrive on the counter pair (count, generation) that `n` arrivals
// complete, and, if `wait`, spin until they have. The last arrival zeroes
// the count and advances the generation, so the pair is ready for the
// next call with no memset. Called by one thread after a fence.
__device__ __forceinline__ void arrive(unsigned* count, unsigned n,
                                       bool wait) {
  unsigned* gen = count + 1;
  const unsigned g0 = ld_acquire(gen);
  if (atomicAdd(count, 1u) == n - 1) {
    atomicExch(count, 0u);
    __threadfence();
    atomicAdd(gen, 1u);
  } else if (wait) {
    const long long start = clock64();
    while (ld_acquire(gen) == g0) {
      if (clock64() - start > kHangCycles) __trap();
      __nanosleep(64);
    }
  }
}

// The split of one call (from the wrapper's plan) and the step geometry.
struct Args {
  int C, Co, d;
  int hs, wsz;          // a pixel step: hs rows x wsz columns
  int wide;             // x: one box for the three taps (else three)
  int stages, stage_bytes;
  int tiles_w, tiles_h, KT, NT, T, P;
};

__global__ void __launch_bounds__(kThreads, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_g,
                  __nv_bfloat16* __restrict__ dk, float* __restrict__ ws,
                  __nv_bfloat16* __restrict__ s9,
                  unsigned* __restrict__ flags, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full_bar = base + kBarOffset;          // kMaxStages x 8 B
  const uint32_t empty_bar = full_bar + kMaxStages * 8;  // kMaxStages x 8 B
  const int wg = threadIdx.x / 128;
  const int G = gridDim.x;
  const int P = a.P;
  const long long U = static_cast<long long>(a.T) * P;
  const long long u_begin = blockIdx.x * U / G;
  const long long u_end = (blockIdx.x + 1LL) * U / G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty_bar + 8 * s, 12);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A segment is the block's residues [r0, r1) of one tile; its pixel
  // steps in order are each period's residues in turn, kt = base + r for
  // base = 0, P, 2P, ... while kt < KT (at least one, as P <= KT). Tile t
  // is tap row t % 3 of input channels 64 * (t / 3 / NT) and output
  // channels 128 * (t / 3 % NT).
  if (wg == 0) {
    // Producer: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // No division a step: the stage and its parity, and kt's (b, th, tw),
      // advance by additions (a division only when tw wraps).
      int s = 0;
      uint32_t phase = 0;
      for (long long u = u_begin; u < u_end;) {
        const int tile = static_cast<int>(u / P);
        const int r0 = static_cast<int>(u % P);
        const int r1 = static_cast<int>(min(
            static_cast<long long>(P), u_end - static_cast<long long>(tile) * P));
        const int i = tile % kTaps;
        const int m0 = (tile / kTaps / a.NT) * kTM;
        const int n0 = (tile / kTaps % a.NT) * kTN;
        int tw = r0 % a.tiles_w;
        int th = r0 / a.tiles_w % a.tiles_h;
        int b = r0 / a.tiles_w / a.tiles_h;
        for (int kt = r0, r = r0; kt < a.KT;) {
          const int w0 = tw * a.wsz;
          const int h0 = th * a.hs;
          const int xh = h0 + (i - 1) * a.d;
          mbar_wait(empty_bar + 8 * s, phase ^ 1);
          const uint32_t dst = base + s * a.stage_bytes;
          const uint32_t bar = full_bar + 8 * s;
          mbar_expect_tx(bar, a.stage_bytes);
#pragma unroll
          for (int q = 0; q < kTN / 64; ++q)
            tma_load_4d(dst + q * kBoxBytes, &tm_g, bar, n0 + 64 * q, h0, w0,
                        b);
          if (a.wide) {
            tma_load_4d(dst + kGBytes, &tm_x, bar, m0, xh, w0 - a.d, b);
          } else {
            for (int j = 0; j < kTaps; ++j)
              tma_load_4d(dst + kGBytes + j * kBoxBytes, &tm_x, bar, m0, xh,
                          w0 + (j - 1) * a.d, b);
          }
          if (++s == a.stages) {
            s = 0;
            phase ^= 1;
          }
          // the next pixel step: the next residue, or the first residue of
          // the next period
          int adv = 1;
          if (++r == r1) {
            r = r0;
            adv = P - (r1 - r0) + 1;
          }
          kt += adv;
          tw += adv;
          if (tw >= a.tiles_w) {
            const int carry = tw / a.tiles_w;
            tw -= carry * a.tiles_w;
            th += carry;
            if (th >= a.tiles_h) {
              const int carry_h = th / a.tiles_h;
              th -= carry_h * a.tiles_h;
              b += carry_h;
            }
          }
        }
        u = static_cast<long long>(tile) * P + r1;
      }
    }
  } else {
    // Consumers: warpgroup j computes tap column j of the tile's row.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    const int j = wg - 1;
    const int ct = threadIdx.x - 128;  // 0 .. 383 over the consumers
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    // Tap j reads the x rows j*d pixel columns on: a whole number of
    // 1024-byte swizzle atoms (hs * d is a multiple of 8) in the wide box.
    const uint32_t xoff =
        kGBytes + (a.wide ? j * a.d * a.hs * 128 : j * kBoxBytes);
    // Register 4q+e holds tile row (input channel) row0 + 8*(e >= 2),
    // column (output channel) 8q + 2*(lane%4) + (e&1).
    const int row0 = warp * 16 + lane / 4;
    // A segment's pixel steps: (r1 - r0) * q, plus one for each of its
    // residues below rem (the residues of KT = q * P + rem).
    const int q_steps = a.KT / P;
    const int rem = a.KT % P;
    int s = 0;
    uint32_t phase = 0;
    for (long long u = u_begin; u < u_end;) {
      const int tile = static_cast<int>(u / P);
      const int r0 = static_cast<int>(u % P);
      const long long t_begin = static_cast<long long>(tile) * P;
      const long long t_end = t_begin + P;
      const int r1 = static_cast<int>(min(t_end, u_end) - t_begin);
      const int steps = (r1 - r0) * q_steps + max(0, min(r1, rem) - r0);
      const int tap = kTaps * (tile % kTaps) + j;
      const int m0 = (tile / kTaps / a.NT) * kTM;
      const int n0 = (tile / kTaps % a.NT) * kTN;
      // The products of at most kFlush steps accumulate in the wgmma
      // registers (the tensor cores' own float32 accumulation loses
      // precision over long runs); a longer segment adds each run into
      // this thread's float32 sums (rounded to nearest), and takes them
      // back after its last run.
      float acc[kTN / 2], sums[kTN / 2];
#pragma unroll
      for (int q = 0; q < kTN / 2; ++q) acc[q] = 0.f;
      int held = 0;  // the stage of the previous step
      for (int step = 0; step < steps; ++step) {
        mbar_wait(full_bar + 8 * s, phase);
        const uint32_t st = base + s * a.stage_bytes;
        const uint64_t da = sw128_mn_desc(st + xoff, kBoxBytes);
        const uint64_t db = sw128_mn_desc(st, kBoxBytes);
        const int fresh = step % kFlush == 0;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kPK / 16; ++kk)  // 16 pixels: 2 row groups
          wgmma_m64n128k16<1, 1>(acc, da + kk * (2048 >> 4),
                                 db + kk * (2048 >> 4),
                                 (!fresh || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products have read their stage
        fence_acc(acc);
        if (step > 0 && lane == 0) mbar_arrive(empty_bar + 8 * held);
        held = s;
        if (++s == a.stages) {
          s = 0;
          phase ^= 1;
        }
        if ((step + 1) % kFlush == 0 && step + 1 < steps) {
          wgmma_wait<0>();
          fence_acc(acc);
          const bool first_run = step + 1 == kFlush;
#pragma unroll
          for (int q = 0; q < kTN / 2; ++q)
            sums[q] = first_run ? acc[q] : sums[q] + acc[q];
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * held);
      if (steps > kFlush) {
#pragma unroll
        for (int q = 0; q < kTN / 2; ++q) acc[q] += sums[q];
      }
      u = t_begin + r1;

      if (r0 == 0 && r1 == P) {
        // The whole tile: straight from the registers to s9.
#pragma unroll
        for (int q = 0; q < kTN / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int m = m0 + row0 + 4 * e;
            const int o = n0 + 8 * q + 2 * (lane % 4);
            if (m < a.C && o < a.Co)
              *reinterpret_cast<__nv_bfloat162*>(
                  s9 + (static_cast<long long>(tap) * a.C + m) * a.Co + o) =
                  __floats2bfloat162_rn(acc[4 * q + e], acc[4 * q + e + 1]);
          }
        continue;
      }

      // A shared tile: the partial to slot blockIdx.x + tile, as (tap
      // column, row = input channel, column = output channel); each store
      // writes whole 32-byte sectors.
      store_run(ws + static_cast<long long>(blockIdx.x + tile) * kPartial +
                    (j * kTM + row0) * kTN + 2 * (lane % 4),
                acc);
      __threadfence();
      consumer_sync();
      const int first = block_of(t_begin, U, G);
      const int last = block_of(t_end - 1, U, G);
      const bool finisher = u == u_end;  // this block's range ends here
      if (ct == 0)
        arrive(flags + 2 * tile, static_cast<unsigned>(last - first + 1),
               finisher);
      if (!finisher) continue;
      consumer_sync();
      // Finishers first .. first + F - 1 (the last block too when its range
      // ends with the tile) take equal shares of the tile's float4s. A
      // thread sums kBatch float4s at once, two partials' loads in flight
      // before their adds, and writes them to s9 as 4 bf16.
      const int F = last - first + ((last + 1LL) * U / G <= t_end ? 1 : 0);
      const int k = blockIdx.x - first;
      const int e_end = (k + 1) * kQuads / F;
      const float4* slots = reinterpret_cast<const float4*>(ws) +
                            static_cast<long long>(tile + first) * kQuads;
      for (int e0 = k * kQuads / F + ct; e0 < e_end;
           e0 += kBatch * kConsumers) {
        float4 tot[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          tot[q] = __ldcg(slots + min(e0 + q * kConsumers, e_end - 1));
        int c = 1;
        for (; c + 1 <= last - first; c += 2) {
          float4 v[kBatch], w[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int e = min(e0 + q * kConsumers, e_end - 1);
            v[q] = __ldcg(slots + static_cast<long long>(c) * kQuads + e);
            w[q] = __ldcg(slots + static_cast<long long>(c + 1) * kQuads + e);
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) add4(tot[q], v[q], w[q]);
        }
        if (c <= last - first) {
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const float4 v = __ldcg(slots + static_cast<long long>(c) * kQuads +
                                    min(e0 + q * kConsumers, e_end - 1));
            tot[q].x += v.x;
            tot[q].y += v.y;
            tot[q].z += v.z;
            tot[q].w += v.w;
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int e = e0 + q * kConsumers;
          const int m = m0 + e / (kTN / 4) % kTM;
          const int o = n0 + 4 * (e % (kTN / 4));
          if (e < e_end && m < a.C && o < a.Co) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(tot[q].x, tot[q].y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(tot[q].z, tot[q].w);
            uint2 pair;
            pair.x = *reinterpret_cast<const unsigned*>(&lo);
            pair.y = *reinterpret_cast<const unsigned*>(&hi);
            *reinterpret_cast<uint2*>(
                s9 + (static_cast<long long>(kTaps * (tile % kTaps) +
                                             e / (kTM * kTN / 4)) * a.C + m) *
                         a.Co + o) = pair;
          }
        }
      }
    }

    // Every tile is in s9 (tap, input channel, output channel) once every
    // block is here: then each block turns 32 x 32 (m, o) chunks of it into
    // dk rows, (o, m, tap), through shared memory (the ring is free).
    __threadfence();
    consumer_sync();
    if (ct == 0) arrive(flags + 2 * a.T, static_cast<unsigned>(G), true);
    consumer_sync();
    __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
    const int chunks_o = a.Co / kChunk;
    const int chunks = (a.C / kChunk) * chunks_o;
    constexpr int kRowQuads = kChunk / 8;            // 16-byte loads a row
    constexpr int kLoads = 9 * kChunk * kRowQuads;   // (tap, m) rows x 4
    constexpr int kStores = kChunk * (kChunk * 9 / 8);  // o rows x 36
    static_assert(kLoads % kConsumers == 0 && kStores % kConsumers == 0,
                  "whole rounds of 16-byte moves");
    for (int chunk = blockIdx.x; chunk < chunks; chunk += G) {
      const int mb = (chunk / chunks_o) * kChunk;
      const int ob = (chunk % chunks_o) * kChunk;
      // 8 output channels of one (tap, m) row of s9 a thread, all its
      // loads in flight before the shared-memory stores
      uint4 v[kLoads / kConsumers];
#pragma unroll
      for (int k = 0; k < kLoads / kConsumers; ++k) {
        const int idx = ct + k * kConsumers;
        const int mm = idx / kRowQuads % kChunk;
        const int tp = idx / kRowQuads / kChunk;
        v[k] = __ldcg(reinterpret_cast<const uint4*>(
            s9 + (static_cast<long long>(tp) * a.C + mb + mm) * a.Co + ob +
            8 * (idx % kRowQuads)));
      }
#pragma unroll
      for (int k = 0; k < kLoads / kConsumers; ++k) {
        const int idx = ct + k * kConsumers;
        const int mm = idx / kRowQuads % kChunk;
        const int tp = idx / kRowQuads / kChunk;
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[k]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          sm[(8 * (idx % kRowQuads) + q) * kChunkPitch + mm * 9 + tp] = e[q];
      }
      consumer_sync();
      // 32 rows o of 32 * 9 bf16: 36 16-byte stores each (C % 32 == 0, so
      // a row starts 576-byte aligned)
#pragma unroll
      for (int k = 0; k < kStores / kConsumers; ++k) {
        const int idx = ct + k * kConsumers;
        const int col = idx % (kChunk * 9 / 8);
        const int oo = idx / (kChunk * 9 / 8);
        *reinterpret_cast<uint4*>(
            dk + (static_cast<long long>(ob + oo) * a.C + mb) * 9 + 8 * col) =
            *reinterpret_cast<const uint4*>(sm + oo * kChunkPitch + 8 * col);
      }
      consumer_sync();
    }
  }
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// One call's shapes, step geometry and the wrapper's plan: G blocks over
// the T*P (tile, residue) units.
struct Plan {
  Args a;
  int G;
  long long slot_bytes, ws_bytes;
};

bool make_plan(int B, int H, int W, int C, int Co, int d, int P, int G,
               Plan* p) {
  if (!shape_ok(B, H, W, C, Co, d, kAlign)) return false;
  const int sms = sm_count();
  Args& a = p->a;
  a.C = C;
  a.Co = Co;
  a.d = d;
  // One x box serves the three taps of a row when the tap's shift, d
  // pixel columns, is a whole number of swizzle atoms: steps of hs = 8 /
  // gcd(d, 8) rows, hs * d a multiple of 8 (d = 2: 4 x 16; d = 4: 2 x 32),
  // the box (64 + 2 d hs) rows of 128 bytes. Past lcm(d, 8) = 64 three
  // boxes of 2 x 32 pixels take less.
  const int g8 = gcd_int(d, 8);
  a.wide = d / g8 * 8 <= 64;
  a.hs = a.wide ? 8 / g8 : 2;
  a.wsz = kPK / a.hs;
  const int xbytes = a.wide ? 128 * (kPK + 2 * d * a.hs) : kTaps * kBoxBytes;
  a.stage_bytes = kGBytes + xbytes;
  a.tiles_w = (W + a.wsz - 1) / a.wsz;
  a.tiles_h = (H + a.hs - 1) / a.hs;
  a.KT = B * a.tiles_h * a.tiles_w;
  a.NT = (Co + kTN - 1) / kTN;
  a.T = kTaps * ((C + kTM - 1) / kTM) * a.NT;
  a.P = P;
  p->G = G;
  // A residue past KT would leave a unit with no pixel step; more blocks
  // than SMs could leave a block waiting on one not yet resident.
  if (P < 1 || P > a.KT || G < 1 || G > sms ||
      G > static_cast<long long>(a.T) * P)
    return false;
  a.stages = kRingBytes / a.stage_bytes;
  if (a.stages > kMaxStages) a.stages = kMaxStages;
  // Slots block + tile (at most G + T - 1; none when P == 1: whole tiles
  // only), then s9: bf16 (9, C, Co).
  p->slot_bytes = P > 1 ? (G + a.T - 1LL) * kPartial * 4 : 0;
  p->ws_bytes = p->slot_bytes + 9LL * C * Co * 2;
  return true;
}

// A 4-D map over a channels-last (B, H, W, C) bf16 tensor with H before W
// (dims C, H, W, B): a box's 128-byte rows run down hs rows of a pixel
// column before the next column, so a shift of d columns moves hs * d
// rows.
bool encode_chw_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                    int B, int H, int W, int C, int bh, int bw) {
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)W,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * C * e, C * e,
                                 (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {64, (cuuint32_t)bh, (cuuint32_t)bw, 1};
  return encode_map(fn, map, ptr, 4, dims, strides, box);
}

}  // namespace

// Bytes of workspace that halo_dilated_conv3x3_wgrad_bf16 needs for these
// shapes and plan (P residues a tile, G blocks) on the current device: the
// float32 partials of shared tiles, then dk as bf16 (9, C, Co); -1 for
// shapes or a plan it refuses.
extern "C" long long halo_dilated_conv3x3_wgrad_workspace(int B, int H, int W,
                                                          int C, int Co, int d,
                                                          int P, int G) {
  Plan p;
  return make_plan(B, H, W, C, Co, d, P, G, &p) ? p.ws_bytes : -1;
}

// x: (B, H, W, C) bf16; g: (B, H, W, Co) bf16; dk: (Co, C, 3, 3) bf16;
// ws: scratch of ws_bytes (the workspace entry's count); flags:
// flag_words uint32 counters, zero when first handed over and left at
// zero counts by every call, at least 2 a tile + 2, used by one stream at
// a time. All contiguous, x and g 16-byte aligned.
extern "C" int halo_dilated_conv3x3_wgrad_bf16(const void* x, const void* g,
                                               void* dk, void* ws,
                                               long long ws_bytes, void* flags,
                                               long long flag_words, int B,
                                               int H, int W, int C, int Co,
                                               int d, int P, int G,
                                               void* stream) {
  Plan p;
  if (!make_plan(B, H, W, C, Co, d, P, G, &p) || ws_bytes < p.ws_bytes ||
      flags == nullptr || flag_words < 2LL * p.a.T + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_x, tm_g;
  const int xw = p.a.wide ? p.a.wsz + 2 * d : p.a.wsz;
  if (!encode_chw_map(fn, &tm_x, x, B, H, W, C, p.a.hs, xw) ||
      !encode_chw_map(fn, &tm_g, g, B, H, W, Co, p.a.hs, p.a.wsz))
    return static_cast<int>(cudaErrorInvalidValue);
  // Once a process: the shared-memory opt-in.
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  unsigned char* w = static_cast<unsigned char*>(ws);
  wgrad_bf16_kernel<<<p.G, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_g, static_cast<__nv_bfloat16*>(dk), reinterpret_cast<float*>(w),
      reinterpret_cast<__nv_bfloat16*>(w + p.slot_bytes),
      static_cast<unsigned*>(flags), p.a);
  return static_cast<int>(cudaGetLastError());
}
