// Kernel C: dense 3x3 convolution, stride 1, padding d, dilation d.
//
// Replaces the TPU kernel dilated_conv3x3 (halo_tpu/ops/pallas_conv.py:150,
// _conv_impl :118, body _kernel :103). For a channels-last input x
// (B, H, W, C), with the tap (i, j) reading the input shifted by
// ((i - 1) d, (j - 1) d):
//   y[b,h,w,o] = sum_{i,j,c} x[b, h + (i-1)d, w + (j-1)d, c] k[o, c, i, j]
// where reads outside the image are zeros, accumulated in float32 and
// stored once in the input's dtype. The same kernel computes the input
// gradient of that convolution when given the cotangent and the flipped,
// IO-transposed weight (the wrapper repacks it; pallas_conv.py:166-175).
//
// What bounds it on an H100: operations. A layer3 call of the R101 trunk
// (B = 2, 90x160, C = Co = 256) is 2*2*90*160*9*256*256 = 34.0 GFLOP
// against ~15 MB read and written, ~2300 FLOP a byte, far above the card's
// ~295 FLOP/byte bf16 ridge: its bound is 34.0 GFLOP / 989 TFLOP/s =
// 0.034 ms, and 0.137 ms for a 512-channel layer4 call. Only wgmma reaches
// the tensor cores' full rate, so the bf16 kernel is built around it.
//
// bf16 design: an implicit GEMM fed by the Tensor Memory Accelerator. The
// TPU kernel kept one image's whole padded input (7 MB) in VMEM; an SM has
// 227 KB, so here a block computes (128 pixels x 256 output channels)
// tiles, the pixels a 4 x 32 patch of one image, and walks the reduction
// over 9 taps x C in steps of 64 channels (one 128-byte line a pixel).
//  - Operand A of a step is one TMA box of a 4-D tensor map over the
//    channels-last input, dims (C, W, H, B) innermost first, box
//    (64, 32, 4, 1), loaded at (k0, w0 + (j-1)d, h0 + (i-1)d, b): the tap's
//    shift is in the coordinates, and TMA zero-fills every element outside
//    the tensor (the padding margin, ragged edges, channels past C), so no
//    padded copy is made and no thread computes an address.
//  - Operand B is a box of 64 channels x 256 outputs of one tap, from a
//    3-D map over the weight repacked K-major like A, as (9, Co, C).
//  - Both land 128B-swizzled, the layout wgmma reads through a shared
//    memory descriptor. One producer thread keeps a ring of 4 stages
//    (48 KB each) in flight against full/empty mbarrier pairs; two
//    consumer warpgroups each issue wgmma m64n256k16 (bf16 in, float32
//    accumulators in registers), four a stage. A tile of 128 x 256 does
//    85 FLOP a byte of shared-memory traffic (a 128 x 128 tile does 64,
//    and measured ~20% slower a tile). setmaxnreg moves registers from the
//    producer's warpgroup to the consumers'.
//  - Persistent: one block an SM walks the tiles with the output channels
//    inner, so the 9 shifted A boxes of a pixel tile are read again from
//    L2, not from device memory. When the last round of tiles would fill
//    at most half the SMs, its tiles run as two 128 x 128 halves each
//    (wgmma m64n128k16), so the call ends half a tile sooner.
//  - Epilogue: each consumer warpgroup rounds its 64 x 256 accumulators to
//    bf16 and, 128 channels at a time, writes them 128B-swizzled (bank-
//    conflict free) to its own 16 KB staging buffer and TMA-stores them;
//    the store clips the ragged H, W and Co edges. The next tile's loads
//    overlap the epilogue, and the buffer is reused after a bulk wait.
// The host encodes the three tensor maps on every call (they hold the base
// pointers) through cuTensorMapEncodeTiled, fetched with
// cudaGetDriverEntryPoint so that the library needs no -lcuda.
//
// A float32 instantiation (TPU.COMPUTE_DTYPE float32) stays in float32
// FMAs (no TF32), as the JAX package computes it, over the weight repacked
// as (9, C, Co). Its bound is the card's 67 TFLOP/s of float32 (0.507 ms
// at layer3), so it is a register-tiled SIMT implicit GEMM: 128 x 128
// outputs a block of 256 threads, 8 x 8 a thread read as four 16-byte
// shared loads a channel (64 FMAs for 4 loads, no bank conflicts), 16
// channels a step, two buffers a tile with one barrier a step; the next
// step's tiles load while the FMAs run: B by cp.async (a zero source size
// past Co), A through registers (it is transposed on its way to shared
// memory, which cp.async cannot do). Two blocks an SM.

#include "dilated_conv.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 kernel: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int kTW = 32;                // pixel tile: 4 rows of 32 pixels
constexpr int kTH = 4;
constexpr int kBM = kTW * kTH;         // 128 pixels a tile
constexpr int kBN = 256;               // output channels a tile
constexpr int kBK = 64;                // channels a step: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;             // 16 KB
constexpr int kBBytes = kBN * kBK * 2;             // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kHalfBytes = 64 * 64 * 2;            // 64 pixels x 64 channels
constexpr int kEpiCols = 128;                      // channels a store pass
constexpr int kEpiBytes = 2 * kHalfBytes;          // a consumer's 64 x 128
constexpr int kBarOffset = kStages * kStageBytes + 2 * kEpiBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + align
constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kBf16Align = 32;         // the C and Co rule (supports())

static_assert(kBM == 2 * 64, "two consumer warpgroups of 64 rows");
static_assert(64 % kTW == 0, "a consumer's 64 pixels are whole tile rows");

// A work item: a (128-pixel x 256-channel) tile, or one 128-channel half
// of one (narrow). Items [0, full_items) are whole tiles in order; after
// them, each remaining tile is two narrow items, its halves side by side.
struct Item {
  int b, h0, w0, n0;
  bool narrow;
};

__device__ __forceinline__ Item decode_item(int item, int full_items,
                                            int tiles_w, int tiles_h,
                                            int n_tiles) {
  Item t;
  int tile = item;
  t.narrow = item >= full_items;
  int half = 0;
  if (t.narrow) {
    tile = full_items + (item - full_items) / 2;
    half = (item - full_items) % 2;
  }
  const int n_tile = tile % n_tiles;  // output channels inner: A from L2
  int m_tile = tile / n_tiles;
  t.w0 = (m_tile % tiles_w) * kTW;
  m_tile /= tiles_w;
  t.h0 = (m_tile % tiles_h) * kTH;
  t.b = m_tile / tiles_h;
  t.n0 = n_tile * kBN + half * (kBN / 2);
  return t;
}

// One work item of a consumer warpgroup: the mainloop over 9 taps x C into
// kN/2 float32 accumulators a thread (wgmma m64nkNk16), then the epilogue.
// `it` counts pipeline steps across items, for the stage and its parity.
template <int kN>
__device__ __forceinline__ void consume_item(const Item& tl, int steps,
                                             int& it, uint32_t base,
                                             uint32_t full_bar,
                                             uint32_t empty_bar, uint32_t epi,
                                             int cw, int H, int Co,
                                             const CUtensorMap* tm_y) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  for (int step = 0; step < steps; ++step, ++it) {
    const int s = it % kStages;
    mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
    const uint64_t da = sw128_desc(base + s * kStageBytes + cw * (64 * 128));
    const uint64_t db = sw128_desc(base + s * kStageBytes + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // +32 bytes along K each
      if constexpr (kN == 256)
        wgmma_m64n256k16<0, 0>(acc, da + 2 * kk, db + 2 * kk,
                         (step > 0 || kk > 0) ? 1 : 0);
      else
        wgmma_m64n128k16<0, 0>(acc, da + 2 * kk, db + 2 * kk,
                               (step > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have read their stage
    fence_acc(acc);
    if (step > 0 && lane == 0)
      mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));

  // Epilogue, in passes of 128 channels through the staging buffer.
  // Accumulator layout of m64nN: register 4j+q holds row warp*16 + lane/4
  // (+8 for q >= 2), column 8j + 2*(lane%4) + (q&1).
  const int r0 = warp * 16 + lane / 4;
  const int hrow = tl.h0 + cw * (64 / kTW);
#pragma unroll
  for (int pass = 0; pass < kN / kEpiCols; ++pass) {
    // The previous store must have read the buffer.
    if (t == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
    for (int jj = 0; jj < kEpiCols / 8; ++jj) {
      const int j = pass * (kEpiCols / 8) + jj;
      const uint32_t half = epi + (jj / 8) * kHalfBytes;
      const uint32_t chunk = ((jj % 8) ^ (r0 % 8)) * 16 + (lane % 4) * 4;
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(half + r0 * 128 + chunk),
                   "r"(*reinterpret_cast<uint32_t*>(&lo))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       half + (r0 + 8) * 128 + chunk),
                   "r"(*reinterpret_cast<uint32_t*>(&hi))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    const int n0 = tl.n0 + pass * kEpiCols;
    if (t == 0 && hrow < H && n0 < Co) {
#pragma unroll
      for (int h = 0; h < kEpiCols / 64; ++h)
        if (n0 + 64 * h < Co)
          tma_store_4d(tm_y, epi + h * kHalfBytes, n0 + 64 * h, tl.w0, hrow,
                       tl.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_w_half,
                 const __grid_constant__ CUtensorMap tm_y, int H, int Co,
                 int d, int tiles_w, int tiles_h, int n_tiles, int k_blocks,
                 int full_items, int total_items) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full_bar = base + kBarOffset;       // kStages x 8 bytes
  const uint32_t empty_bar = full_bar + kStages * 8;  // kStages x 8 bytes
  const int wg = threadIdx.x / 128;
  const int steps = 9 * k_blocks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty_bar + 8 * s, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < total_items; item += gridDim.x) {
        const Item t =
            decode_item(item, full_items, tiles_w, tiles_h, n_tiles);
        const CUtensorMap* wmap = t.narrow ? &tm_w_half : &tm_w;
        const uint32_t bytes = kABytes + (t.narrow ? kBBytes / 2 : kBBytes);
        for (int step = 0; step < steps; ++step, ++it) {
          const int tap = step / k_blocks;
          const int k0 = (step % k_blocks) * kBK;
          const int s = it % kStages;
          mbar_wait(empty_bar + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t a_dst = base + s * kStageBytes;
          mbar_expect_tx(full_bar + 8 * s, bytes);
          tma_load_4d(a_dst, &tm_x, full_bar + 8 * s, k0,
                      t.w0 + (tap % 3 - 1) * d, t.h0 + (tap / 3 - 1) * d,
                      t.b);
          tma_load_3d(a_dst + kABytes, wmap, full_bar + 8 * s, k0, t.n0, tap);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns pixel rows cw*64 .. cw*64+63 of a tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const uint32_t epi = base + kStages * kStageBytes + cw * kEpiBytes;
    int it = 0;
    for (int item = blockIdx.x; item < total_items; item += gridDim.x) {
      const Item tl =
          decode_item(item, full_items, tiles_w, tiles_h, n_tiles);
      if (tl.narrow)
        consume_item<kBN / 2>(tl, steps, it, base, full_bar, empty_bar, epi,
                              cw, H, Co, &tm_y);
      else
        consume_item<kBN>(tl, steps, it, base, full_bar, empty_bar, epi, cw,
                          H, Co, &tm_y);
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32 SIMT kernel: a register-tiled implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kFM = 128;               // pixels a block
constexpr int kFN = 128;               // output channels a block
constexpr int kFK = 16;                // channels a step; the C, Co rule
constexpr int kFThreads = 256;         // 16 x 16, 8 x 8 outputs a thread
constexpr int kFPitch = kFM + 4;       // A's row pitch, 16-byte aligned

__global__ void __launch_bounds__(kFThreads, 2)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                float* __restrict__ y, int B, int H, int W, int C, int Co,
                int d) {
  constexpr int kA4 = 2;  // float4s of A a thread a step
  constexpr int kB4 = 2;  // and of B (rows b_k and b_k + 8)
  // Two buffers of each tile, k-major: a row of k holds the block's 128
  // pixels (A) or 128 output channels (B) contiguous.
  __shared__ __align__(16) float As[2][kFK][kFPitch];
  __shared__ __align__(16) float Bs[2][kFK][kFN];
  const int tid = threadIdx.x;
  const int M = B * H * W;
  // Output channels inner in the launch order: a pixel tile's A is read
  // from L2 by its neighbours.
  const int n_tiles = (Co + kFN - 1) / kFN;
  const int n0 = (blockIdx.x % n_tiles) * kFN;
  const int m0 = (blockIdx.x / n_tiles) * kFM;

  // A loads: one pixel and 8 channels a thread; a warp's lanes take 32
  // neighbouring pixels, so the transposing stores to As land in 32 banks.
  const int a_m = tid % kFM;
  const int a_k = (tid / kFM) * (kFK / 2);
  const int am = m0 + a_m;
  const bool a_in = am < M;
  const int amm = a_in ? am : 0;
  const int aw = amm % W, ah = (amm / W) % H;
  const float* xa = x + static_cast<long long>(amm) * C + a_k;
  // B loads: rows b_k + 8r, one 16-byte cp.async each; a warp copies 512
  // contiguous bytes of a row. Past Co (Co % 16 == 0: a copy is wholly in
  // or out) the source size is zero and the copy writes zeros.
  const int b_k = tid / 32;
  const int b_n = (tid % 32) * 4;
  const bool b_ok = n0 + b_n < Co;
  const float* wb = b_ok ? w9 + static_cast<long long>(b_k) * Co + n0 + b_n
                         : w9;
  const uint32_t bs = smem_addr(&Bs[0][b_k][b_n]);

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int k_steps = C / kFK;
  const int steps = 9 * k_steps;
  float4 ra[kA4];  // the next step's A, prefetched into registers
  auto load = [&](int step, int buf) {
    const int tap = step / k_steps;
    const int k0 = (step % k_steps) * kFK;
    const int dh = (tap / 3 - 1) * d, dw = (tap % 3 - 1) * d;
    const bool in = a_in && ah + dh >= 0 && ah + dh < H && aw + dw >= 0 &&
                    aw + dw < W;
    const float4* pa = reinterpret_cast<const float4*>(
        xa + static_cast<long long>(dh * W + dw) * C + k0);
#pragma unroll
    for (int r = 0; r < kA4; ++r)
      ra[r] = in ? pa[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* pb = wb + (b_ok ? (static_cast<long long>(tap) * C + k0) *
                                       Co
                                 : 0);
#pragma unroll
    for (int r = 0; r < kB4; ++r)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       bs + (buf * kFK * kFN + 8 * r * kFN) * 4),
                   "l"(pb + (b_ok ? 8LL * r * Co : 0)), "r"(b_ok ? 16 : 0)
                   : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kA4; ++r) {
      As[buf][a_k + 4 * r + 0][a_m] = ra[r].x;
      As[buf][a_k + 4 * r + 1][a_m] = ra[r].y;
      As[buf][a_k + 4 * r + 2][a_m] = ra[r].z;
      As[buf][a_k + 4 * r + 3][a_m] = ra[r].w;
    }
  };

  load(0, 0);
  store(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) load(step + 1, buf ^ 1);  // in flight over the FMAs
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      // Rows ty*4.. and 64+ty*4.., columns tx*4.. and 64+tx*4..: four
      // 16-byte loads, broadcast (A) or 256 contiguous bytes (B) a warp.
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read in the previous step, before the
    // barrier that ended it: one barrier a step.
    if (more) store(buf ^ 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < Co)
        *reinterpret_cast<float4*>(y + static_cast<long long>(m) * Co + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

}  // namespace

// x: (B, H, W, C) bf16, wk: the weight repacked K-major as (9, Co, C)
// bf16, y: (B, H, W, Co) bf16; all contiguous and 16-byte aligned.
extern "C" int halo_dilated_conv3x3_bf16(const void* x, const void* wk,
                                         void* y, int B, int H, int W, int C,
                                         int Co, int d, void* stream) {
  if (!shape_ok(B, H, W, C, Co, d, kBf16Align))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = 2;  // bytes a bf16
  CUtensorMap tm_x, tm_w, tm_w_half, tm_y;
  // Dims innermost first: (C, Co, 9).
  const cuuint64_t w_dims[3] = {(cuuint64_t)C, (cuuint64_t)Co, 9};
  const cuuint64_t w_strides[2] = {C * e, (cuuint64_t)Co * C * e};
  const cuuint32_t w_box[3] = {kBK, kBN, 1};
  const cuuint32_t w_half_box[3] = {kBK, kBN / 2, 1};
  if (!encode_nhwc_map(fn, &tm_x, x, B, H, W, C, kTW, kTH) ||
      !encode_map(fn, &tm_w, wk, 3, w_dims, w_strides, w_box) ||
      !encode_map(fn, &tm_w_half, wk, 3, w_dims, w_strides, w_half_box) ||
      !encode_nhwc_map(fn, &tm_y, y, B, H, W, Co, kTW, 64 / kTW))
    return static_cast<int>(cudaErrorInvalidValue);

  // Once a process: the SM count and the shared-memory opt-in.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const int n_tiles = (Co + kBN - 1) / kBN;
  const int k_blocks = (C + kBK - 1) / kBK;
  const int tiles = B * tiles_h * tiles_w * n_tiles;
  // The last round of whole tiles would leave SMs idle; when its tiles cut
  // in half fit on the card at once, they run as halves, which ends the
  // call half a tile sooner (512 channels at 90x160: 460 tiles are 3 full
  // rounds on 132 SMs plus 64 tiles as 128 halves).
  const int tail = tiles - (tiles - 1) / sms * sms;
  const bool split = 2 * tail <= sms;
  const int full_items = split ? tiles - tail : tiles;
  const int total = split ? tiles + tail : tiles;
  const int grid = total < sms ? total : sms;
  conv_bf16_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, tm_w_half, tm_y, H, Co, d, tiles_w, tiles_h, n_tiles,
      k_blocks, full_items, total);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, H, W, C) f32; w9: the weight repacked as (9, C, Co) f32.
extern "C" int halo_dilated_conv3x3_f32(const void* x, const void* w9, void* y,
                                        int B, int H, int W, int C, int Co,
                                        int d, void* stream) {
  if (!shape_ok(B, H, W, C, Co, d, kFK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * H * W;
  const int grid = ((Co + kFN - 1) / kFN) * ((M + kFM - 1) / kFM);
  conv_f32_kernel<<<grid, kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(w9),
          static_cast<float*>(y), B, H, W, C, Co, d);
  return static_cast<int>(cudaGetLastError());
}
