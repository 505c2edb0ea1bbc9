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
//  - Operand B is a box (64, 256, 1) of a 3-D map over the weight repacked
//    as (9, Co, C), K-major like A.
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
// A float32 instantiation (TPU.COMPUTE_DTYPE float32) runs a plain SIMT
// tile (64x64, 4x4 outputs a thread, float32 FMAs, no TF32) over the
// weight repacked as (9, C, Co), so the f32 path stays f32 as in the JAX
// package.

#include <cuda.h>  // CUtensorMap and the encoder's types; no driver calls
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// A wait this long means a broken pipeline: trap rather than hang the card.
constexpr long long kHangCycles = 1LL << 33;

static_assert(kBM == 2 * 64, "two consumer warpgroups of 64 rows");
static_assert(64 % kTW == 0, "a consumer's 64 pixels are whole tile rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      start = clock64();
    else if (clock64() - start > kHangCycles)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows,
// 128B-swizzled, 1024-byte aligned: 8-row core groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // 128B swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the async
// wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major smem) * B (256 x 16, K-major smem)^T.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, K-major smem) * B (128 x 16, K-major smem)^T.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

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
        wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk,
                         (step > 0 || kk > 0) ? 1 : 0);
      else
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk,
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
          tma_load_3d(a_dst + kABytes, wmap, full_bar + 8 * s, k0, t.n0,
                      tap);
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against the runtime alone.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map over a dense tensor: dims innermost first, strides in
// bytes of dims 1.., 128B swizzle, zero fill outside the tensor.
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// float32 SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

__global__ void __launch_bounds__(256)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                float* __restrict__ y, int B, int H, int W, int C, int Co,
                int d) {
  __shared__ float As[kFK][kFM + 4];  // k-major: a row of k is contiguous
  __shared__ float Bs[kFK][kFN];
  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;

  // A loads: one pixel row and one float4 of channels a thread.
  const int a_row = tid / 4;
  const int a_c4 = (tid % 4) * 4;
  const int am = m0 + a_row;
  const bool a_in = am < M;
  const int amm = a_in ? am : 0;
  const int aw = amm % W, ah = (amm / W) % H, ab = amm / (W * H);
  // B loads: one channel row and one float4 of outputs a thread.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 4;
  const bool b_ok = n0 + b_col < Co;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  const int k_steps = C / kFK;
  for (int step = 0; step < 9 * k_steps; ++step) {
    const int tap = step / k_steps;
    const int k0 = (step % k_steps) * kFK;
    const int hh = ah + (tap / 3 - 1) * d;
    const int ww = aw + (tap % 3 - 1) * d;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_in && hh >= 0 && hh < H && ww >= 0 && ww < W)
      av = *reinterpret_cast<const float4*>(
          x + ((static_cast<long long>(ab) * H + hh) * W + ww) * C + k0 +
          a_c4);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b_ok)
      bv = *reinterpret_cast<const float4*>(
          w9 + (static_cast<long long>(tap) * C + k0 + b_row) * Co + n0 +
          b_col);
    __syncthreads();  // the previous step's tiles are consumed
    As[a_c4 + 0][a_row] = av.x;
    As[a_c4 + 1][a_row] = av.y;
    As[a_c4 + 2][a_row] = av.z;
    As[a_c4 + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    const int n = n0 + tx * 4;
    if (m < M && n < Co)
      *reinterpret_cast<float4*>(y + static_cast<long long>(m) * Co + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The rule of ops/dilated_conv.py:supports. It is symmetric in C and Co:
// the input gradient runs this kernel with the two swapped, so a forward
// that launches has an input gradient that launches too.
bool shape_ok(int B, int H, int W, int C, int Co, int d, int k_align) {
  const long long m = static_cast<long long>(B) * H * W;
  return B > 0 && H > 0 && W > 0 && d >= 1 && C > 0 && C % k_align == 0 &&
         Co > 0 && Co % k_align == 0 && m * (C > Co ? C : Co) < (1LL << 31);
}

}  // namespace

// x: (B, H, W, C) bf16; wk: the weight repacked K-major as (9, Co, C) bf16;
// y: (B, H, W, Co) bf16. All 16-byte aligned and contiguous.
extern "C" int halo_dilated_conv3x3_bf16(const void* x, const void* wk,
                                         void* y, int B, int H, int W, int C,
                                         int Co, int d, void* stream) {
  if (!shape_ok(B, H, W, C, Co, d, kBf16Align))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = 2;  // bytes a bf16
  CUtensorMap tm_x, tm_w, tm_w_half, tm_y;
  const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {C * e, (cuuint64_t)W * C * e,
                                   (cuuint64_t)H * W * C * e};
  const cuuint32_t x_box[4] = {kBK, kTW, kTH, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)C, (cuuint64_t)Co, 9};
  const cuuint64_t w_strides[2] = {C * e, (cuuint64_t)Co * C * e};
  const cuuint32_t w_box[3] = {kBK, kBN, 1};
  const cuuint32_t w_half_box[3] = {kBK, kBN / 2, 1};
  const cuuint64_t y_dims[4] = {(cuuint64_t)Co, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint64_t y_strides[3] = {Co * e, (cuuint64_t)W * Co * e,
                                   (cuuint64_t)H * W * Co * e};
  const cuuint32_t y_box[4] = {64, kTW, 64 / kTW, 1};
  if (!encode_map(fn, &tm_x, x, 4, x_dims, x_strides, x_box) ||
      !encode_map(fn, &tm_w, wk, 3, w_dims, w_strides, w_box) ||
      !encode_map(fn, &tm_w_half, wk, 3, w_dims, w_strides, w_half_box) ||
      !encode_map(fn, &tm_y, y, 4, y_dims, y_strides, y_box))
    return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  dim3 grid((M + kFM - 1) / kFM, (Co + kFN - 1) / kFN);
  conv_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w9),
      static_cast<float*>(y), B, H, W, C, Co, d);
  return static_cast<int>(cudaGetLastError());
}
