// Kernel I: the int8 (W8A8) convolution of the quantised evaluation path,
// for every quantised layer: k x k convs, 1x1 convs (strided or not) and
// dense layers (a one-tap conv whose input is M pixels).
//
// Replaces no Pallas kernel. The JAX package's int8 conv and dense layer
// (halo_tpu/ops/quant.py:81 int8_conv, :97 int8_dense) are one XLA
// convolution or dot of int8 operands with int32 accumulation; PyTorch has
// no int8 convolution on CUDA (F.conv2d takes no integer tensors there, and
// cuDNN's int8 paths are not exposed), so the port carries this kernel.
//
// What it computes, for kernel Q's int8 NHWC input x (channels zero-padded
// to Cp, a multiple of 16; int8_quant.cu), pack_weight's K-major int8
// weight w (Cop >= Co rows of kh*kw*Cp: tap outer, channel inner, zeros
// in the padding), the layer's calibrated absmax and its float32
// per-output-channel weight scales:
//   sx = max(amax, eps) * inv127
//   y[n, ho, wo, co] = float(sum_{i, j, c} x[n, ho*sh - ph + i*dh,
//                                            wo*sw - pw + j*dw, c]
//                                          * w[co, (i*kw + j)*Cp + c])
//                      * (sx * w_scale[co])
// with zero padding (exact: the quantisation is symmetric), int32 sums
// (exact in any order), one float32 product rounded to nearest (the scale
// product too, as ops/quant.py forms it), written NHWC as float32 or
// rounded once more to bfloat16. The plain versions
// (ops/quant.py:int8_conv_plain, int8_gemm_plain) compute the same bits.
//
// What bounds it on an H100: operations at the trunk's and the ASPP's
// shapes (a 3x3 conv at 256 channels does 4608 integer operations an
// output value against 256 bytes of input a pixel: above ~590 operations a
// byte the 1,979 int8 TOPS, not the 3.35 TB/s, are the limit), bytes at
// the narrow ones (layer1's 64 channels, the 1x1 convs of few channels).
// Only wgmma reaches the tensor cores' int8 rate, so the design is kernel
// C's (dilated_conv.cu) with int8 operands:
//  - An implicit GEMM over (output pixels x output channels), K = taps x
//    Cp. A block computes 128 x BN tiles (BN 256, 128 or 64, chosen a call
//    by a cost model of the tile count against the SMs), the 128 pixels a
//    TW x TH patch of one image (TW x TH = 128, chosen to waste the fewest
//    pixels at the edges), and walks K in steps of 128 bytes (one 128B-
//    swizzled line a pixel) or 64 (Cp <= 64: layer1, 64B swizzle).
//  - Operand A of a step is one TMA box of a 4-D map over x, dims (Cp, W,
//    H, N), box (BK, TW*sw, TH*sh, 1) with traversal strides (1, sw, sh,
//    1): the tap's shift is in the box's coordinates, the stride in the
//    map, and TMA's zero fill outside the tensor is the padding (and the
//    channels past Cp), so no thread computes an address or a predicate. A
//    1x1 stride-1 conv or a dense layer is one image of one row of M
//    pixels, boxes of 128.
//  - Operand B is a box of BK bytes x BN output channels of one tap from a
//    3-D map over the packed weight (Cp, taps, Cop).
//  - One producer thread keeps a ring of 3-8 stages (what fits in 196 KB,
//    or 92 KB at BN 64) in flight against full/empty mbarrier pairs; two
//    consumer warpgroups
//    each issue wgmma m64nBNk32 s8 x s8 -> s32 on their 64 rows, one a 32
//    bytes of K, so a block meets a barrier once a stage, not once a
//    64-byte step of all 256 threads. setmaxnreg moves registers from the
//    producer's warpgroup to the consumers'.
//  - Persistent: one block an SM (two at BN 64, whose steps are short:
//    one block's epilogue and load latency hide behind the other's
//    products) walks the tiles, output channels inner (the taps' A boxes
//    come from L2); when the last round of tiles would fill at most half
//    the SMs, its tiles run as two BN/2 halves each.
//  - Epilogue: amax and w_scale read by pointer, float(sum) * (sx *
//    w_scale[co]) rounded once, staged 128 bytes of channels a pass
//    through a padded (bank-conflict free) buffer of each warpgroup, and
//    stored NHWC as 16-byte stores, 8 threads a pixel, masked at the
//    ragged pixel and channel edges. The producer's next loads overlap it.
// The host encodes the two tensor maps on every call (they hold the base
// pointers), through cuTensorMapEncodeTiled fetched with
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Measured on an H100 (PERF.md): what holds it below the operations bound
// is the operands' traffic from L2: a 3x3 conv reads each input pixel
// once a tap, and every tile streams its weight slab; with the products
// and the stores taken out, the loads alone take 60-76% of the time at
// the trunk's shapes (6.8-11 TB/s of stage bytes). Sharing the
// weight tile across a 2-CTA cluster by TMA multicast ran slower at every
// shape, as it did for kernel C's weight gradient.

#include <initializer_list>

#include "dilated_conv.cuh"

namespace {

constexpr int kBM = 128;               // output pixels a tile
constexpr int kI8Threads = 384;        // producer warpgroup + 2 consumers
constexpr int kRingBytes = 196 * 1024;
constexpr int kMaxStages = 8;

// Bytes of a consumer warpgroup's epilogue staging buffer (Epi below).
constexpr int kEpiBytes = 64 * 40 * 4;

// The ring of one (BN, BK) instantiation, then the two staging buffers; at
// BN 64 two blocks share an SM.
template <int BN, int BK>
struct Ring {
  static constexpr int kABytes = kBM * BK;
  static constexpr int kBBytes = BN * BK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBudget = BN == 64 ? 92 * 1024 : kRingBytes;
  static constexpr int kStages = kBudget / kStageBytes < kMaxStages
                                     ? kBudget / kStageBytes
                                     : kMaxStages;
  static constexpr int kEpiOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kEpiOffset + 2 * kEpiBytes;
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;
};

struct Geo {
  int Ho, Wo, Co;
  int kw, sh, sw, ph, pw, dh, dw;
  int tw_log2, th;                 // pixel tile (1 << tw_log2) x th = 128
  int tiles_w, tiles_h, n_tiles;   // tiles of an image, of Co
  int k_blocks, steps;             // BK-byte blocks of Cp; taps * k_blocks
  int full_items, total_items;     // see decode_item
  float eps, inv127;
};

// Descriptor of a K-major operand of BK-byte rows, BK-byte swizzled: 8-row
// core groups 8 * BK bytes apart.
template <int BK>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  static_assert(BK == 128 || BK == 64, "128B or 64B swizzle");
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |                  // LBO (unused)
         (static_cast<uint64_t>((8 * BK) >> 4) << 32) |      // SBO
         (static_cast<uint64_t>(BK == 128 ? 1 : 2) << 62);   // swizzle
}

template <int N>
__device__ __forceinline__ void fence_acc_s32(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 256)
    wgmma_s8_n256(d, da, db, accumulate);
  else if constexpr (N == 128)
    wgmma_s8_n128(d, da, db, accumulate);
  else
    wgmma_s8_n64(d, da, db, accumulate);
}

// A work item: a (128-pixel x BN-channel) tile, or one BN/2 half of one
// (narrow). Items [0, full_items) are whole tiles in order; after them,
// each remaining tile is two narrow items, its halves side by side.
struct Item {
  int b, h0, w0, n0;
  bool narrow;
};

template <int BN>
__device__ __forceinline__ Item decode_item(int item, const Geo& g) {
  Item t;
  int tile = item;
  t.narrow = item >= g.full_items;
  int half = 0;
  if (t.narrow) {
    tile = g.full_items + (item - g.full_items) / 2;
    half = (item - g.full_items) % 2;
  }
  const int n_tile = tile % g.n_tiles;  // output channels inner: A from L2
  int m_tile = tile / g.n_tiles;
  t.w0 = (m_tile % g.tiles_w) << g.tw_log2;
  m_tile /= g.tiles_w;
  t.h0 = (m_tile % g.tiles_h) * g.th;
  t.b = m_tile / g.tiles_h;
  t.n0 = n_tile * BN + half * (BN / 2);
  return t;
}

// A consumer warpgroup's staging buffer for one pass of the epilogue: 64
// rows of kCols output values (128 bytes), the row pitch padded so that
// the writes of a warp (rows lane/4, columns 2*(lane%4)) hit distinct
// banks, and rows 16-byte aligned for the reads.
template <typename Out>
struct Epi;

template <>
struct Epi<float> {
  static constexpr int kCols = 32;
  static constexpr int kPerChunk = 4;    // values a 16-byte chunk
  static constexpr int kPitch = 40;      // words a row
  __device__ static void put(uint32_t buf, int row, int col, float v0,
                             float v1) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                     buf + (row * kPitch + col) * 4),
                 "f"(v0), "f"(v1)
                 : "memory");
  }
  __device__ static uint4 get(uint32_t buf, int row, int chunk) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(buf + (row * kPitch + chunk * 4) * 4)
                 : "memory");
    return v;
  }
};

template <>
struct Epi<__nv_bfloat16> {
  static constexpr int kCols = 64;
  static constexpr int kPerChunk = 8;
  static constexpr int kPitch = 36;
  __device__ static void put(uint32_t buf, int row, int col, float v0,
                             float v1) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     buf + row * kPitch * 4 + col * 2),
                 "r"(*reinterpret_cast<uint32_t*>(&h))
                 : "memory");
  }
  __device__ static uint4 get(uint32_t buf, int row, int chunk) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(buf + (row * kPitch + chunk * 4) * 4)
                 : "memory");
    return v;
  }
};

// One work item of a consumer warpgroup: the mainloop over taps x Cp into
// N/2 int32 accumulators a thread (wgmma m64nNk32), then the epilogue.
// `it` counts pipeline steps across items, for the stage and its parity.
template <int N, int BN, int BK, typename Out>
__device__ __forceinline__ void consume_item(
    const Item& tl, const Geo& g, int& it, uint32_t base, uint32_t full_bar,
    uint32_t empty_bar, uint32_t epi, int cw, const float* __restrict__ amax,
    const float* __restrict__ w_scale, Out* __restrict__ y) {
  using R = Ring<BN, BK>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int step = 0; step < g.steps; ++step, ++it) {
    const int s = it % R::kStages;
    mbar_wait(full_bar + 8 * s, (it / R::kStages) & 1);
    const uint32_t stage = base + s * R::kStageBytes;
    const uint64_t da = kmajor_desc<BK>(stage + cw * (64 * BK));
    const uint64_t db = kmajor_desc<BK>(stage + R::kABytes);
    fence_acc_s32(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // +32 bytes along K each
      wgmma_s8<N>(acc, da + 2 * kk, db + 2 * kk, (step > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have read their stage
    fence_acc_s32(acc);
    if (step > 0 && lane == 0)
      mbar_arrive(empty_bar + 8 * ((it - 1) % R::kStages));
  }
  wgmma_wait<0>();
  fence_acc_s32(acc);
  if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % R::kStages));

  // Epilogue, in passes of Epi<Out>::kCols channels (128 bytes a row)
  // through the warpgroup's staging buffer: the scaled values go to shared
  // memory as the accumulators lie (register 4j+q of m64nN holds row
  // warp*16 + lane/4 (+8 for q >= 2), column 8j + 2*(lane%4) + (q&1)),
  // then each row leaves as 16-byte stores, 8 threads a row.
  using E = Epi<Out>;
  const float sx = __fmul_rn(fmaxf(*amax, g.eps), g.inv127);
  const int r_lo = warp * 16 + lane / 4;
  const bool vec = g.Co % E::kPerChunk == 0;
#pragma unroll
  for (int pass = 0; pass < N / E::kCols; ++pass) {
#pragma unroll
    for (int jj = 0; jj < E::kCols / 8; ++jj) {
      const int j = pass * (E::kCols / 8) + jj;
      const int col = 8 * jj + 2 * (lane % 4);
      const int co = tl.n0 + 8 * j + 2 * (lane % 4);
      const float s0 = co < g.Co ? __fmul_rn(sx, w_scale[co]) : 0.f;
      const float s1 = co + 1 < g.Co ? __fmul_rn(sx, w_scale[co + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        E::put(epi, r_lo + 8 * h, col,
               __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0),
               __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1));
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
    for (int i = 0; i < 64 * 8 / 128; ++i) {
      const int k = t + 128 * i;
      const int row = k / 8;
      const int chunk = k % 8;
      const int r = cw * 64 + row;
      const int ho = tl.h0 + (r >> g.tw_log2);
      const int wo = tl.w0 + (r & ((1 << g.tw_log2) - 1));
      const int co = tl.n0 + pass * E::kCols + chunk * E::kPerChunk;
      if (ho >= g.Ho || wo >= g.Wo || co >= g.Co) continue;
      Out* dst = y + ((static_cast<long long>(tl.b) * g.Ho + ho) * g.Wo +
                      wo) * g.Co + co;
      const uint4 v = E::get(epi, row, chunk);
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const Out* e = reinterpret_cast<const Out*>(&v);
        for (int u = 0; u < E::kPerChunk && co + u < g.Co; ++u) dst[u] = e[u];
      }
    }
    // The buffer is read before the next pass writes it.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }
}

template <int BN, int BK, typename Out>
__global__ void __launch_bounds__(kI8Threads, BN == 64 ? 2 : 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_w_half,
                 const float* __restrict__ amax,
                 const float* __restrict__ w_scale, Out* __restrict__ y,
                 const Geo g) {
  using R = Ring<BN, BK>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full_bar = base + R::kBarOffset;          // kStages x 8 B
  const uint32_t empty_bar = full_bar + R::kStages * 8;    // kStages x 8 B
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty_bar + 8 * s, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every TMA load.
    if constexpr (BN == 64)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < g.total_items; item += gridDim.x) {
        const Item t = decode_item<BN>(item, g);
        const CUtensorMap* wmap = t.narrow ? &tm_w_half : &tm_w;
        const uint32_t bytes =
            R::kABytes + (t.narrow ? R::kBBytes / 2 : R::kBBytes);
        const int hb = t.h0 * g.sh - g.ph;
        const int wb = t.w0 * g.sw - g.pw;
        for (int step = 0; step < g.steps; ++step, ++it) {
          const int tap = step / g.k_blocks;
          const int k0 = (step - tap * g.k_blocks) * BK;
          const int ti = tap / g.kw;
          const int tj = tap - ti * g.kw;
          const int s = it % R::kStages;
          mbar_wait(empty_bar + 8 * s, ((it / R::kStages) & 1) ^ 1);
          const uint32_t a_dst = base + s * R::kStageBytes;
          mbar_expect_tx(full_bar + 8 * s, bytes);
          tma_load_4d(a_dst, &tm_x, full_bar + 8 * s, k0, wb + tj * g.dw,
                      hb + ti * g.dh, t.b);
          tma_load_3d(a_dst + R::kABytes, wmap, full_bar + 8 * s, k0, tap,
                      t.n0);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns pixel rows cw*64 .. cw*64+63 of a tile.
    if constexpr (BN == 64)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const uint32_t epi = base + R::kEpiOffset + cw * kEpiBytes;
    int it = 0;
    for (int item = blockIdx.x; item < g.total_items; item += gridDim.x) {
      const Item tl = decode_item<BN>(item, g);
      if constexpr (BN >= 128) {
        if (tl.narrow) {
          consume_item<BN / 2, BN, BK, Out>(tl, g, it, base, full_bar,
                                            empty_bar, epi, cw, amax,
                                            w_scale, y);
          continue;
        }
      }
      consume_item<BN, BN, BK, Out>(tl, g, it, base, full_bar, empty_bar,
                                    epi, cw, amax, w_scale, y);
    }
  }
}

// An int8 tensor map, dims innermost first, strides in bytes of dims 1..,
// BK-byte swizzle (the box's inner extent), zero fill outside the tensor.
bool encode_i8_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                   int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   const cuuint32_t* element_strides, int bk) {
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
            const_cast<void*>(ptr), dims, strides, box, element_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {
  const void* x;
  const void* w;
  const float* amax;
  const float* w_scale;
  void* y;
  int B, H, W, Cp, Cop, taps;
  cudaStream_t stream;
};

// Cost of one step of a tile a block, in ns of an H100 SM: the larger of
// its wgmma (128 x bn x bk MACs at 1,979 TOPS / 132 SMs) and its loads
// ((128 + bn) x bk bytes at 100 GB/s). Only the ratios matter: they pick
// the tile width.
double step_ns(int bn, int bk) {
  const double mma = 128.0 * bn * bk / 7500.0;
  const double load = (128.0 + bn) * bk / 100.0;
  return mma > load ? mma : load;
}

// The call's schedule at tile width bn: items, and its modelled time.
double schedule(int bn, int bk, int m_tiles, int Co, int sms, int steps,
                int* full_items, int* total_items) {
  const int n_tiles = (Co + bn - 1) / bn;
  const int tiles = m_tiles * n_tiles;
  const int rounds = (tiles - 1) / sms;        // whole rounds before the last
  const int tail = tiles - rounds * sms;
  // The last round's tiles run as halves when the halves fill the SMs at
  // most once (bn >= 128: a half is a wgmma of 64 or more).
  const bool split = bn >= 128 && 2 * tail <= sms;
  *full_items = split ? tiles - tail : tiles;
  *total_items = split ? tiles + tail : tiles;
  return steps * (rounds * step_ns(bn, bk) +
                  (split ? step_ns(bn / 2, bk) : step_ns(bn, bk)));
}

template <int BN, int BK, typename Out>
int launch(const Call& c, Geo g, int sms) {
  using R = Ring<BN, BK>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int tw = 1 << g.tw_log2;
  CUtensorMap tm_x, tm_w, tm_w_half;
  const cuuint64_t x_dims[4] = {(cuuint64_t)c.Cp, (cuuint64_t)c.W,
                                (cuuint64_t)c.H, (cuuint64_t)c.B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)c.Cp,
                                   (cuuint64_t)c.W * c.Cp,
                                   (cuuint64_t)c.H * c.W * c.Cp};
  const cuuint32_t x_box[4] = {(cuuint32_t)BK, (cuuint32_t)(tw * g.sw),
                               (cuuint32_t)(g.th * g.sh), 1};
  const cuuint32_t x_estr[4] = {1, (cuuint32_t)g.sw, (cuuint32_t)g.sh, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)c.Cp, (cuuint64_t)c.taps,
                                (cuuint64_t)c.Cop};
  const cuuint64_t w_strides[2] = {(cuuint64_t)c.Cp,
                                   (cuuint64_t)c.taps * c.Cp};
  const cuuint32_t w_box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)BN};
  const cuuint32_t w_half_box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)(BN / 2)};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (!encode_i8_map(fn, &tm_x, c.x, 4, x_dims, x_strides, x_box, x_estr,
                     BK) ||
      !encode_i8_map(fn, &tm_w, c.w, 3, w_dims, w_strides, w_box, ones, BK) ||
      !encode_i8_map(fn, &tm_w_half, c.w, 3, w_dims, w_strides, w_half_box,
                     ones, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_conv_kernel<BN, BK, Out>;
  // Once a process for each instantiation: the shared-memory opt-in.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int slots = BN == 64 ? 2 * sms : sms;
  const int grid = g.total_items < slots ? g.total_items : slots;
  kernel<<<grid, kI8Threads, R::kSmemBytes, c.stream>>>(
      tm_x, tm_w, tm_w_half, c.amax, c.w_scale, static_cast<Out*>(c.y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int dispatch(const Call& c, Geo g, int m_tiles, int sms) {
  const int bk = c.Cp <= 64 ? 64 : 128;
  g.k_blocks = (c.Cp + bk - 1) / bk;
  g.steps = c.taps * g.k_blocks;
  int bn = 64, full = 0, total = 0;
  double best = -1.0;
  for (int cand : {256, 128, 64}) {
    int f, t;
    const double cost = schedule(cand, bk, m_tiles, g.Co, sms, g.steps, &f,
                                 &t);
    if (best < 0.0 || cost < best) {
      best = cost;
      bn = cand;
      full = f;
      total = t;
    }
  }
  g.n_tiles = (g.Co + bn - 1) / bn;
  g.full_items = full;
  g.total_items = total;
  if (bk == 128) {
    if (bn == 256) return launch<256, 128, Out>(c, g, sms);
    if (bn == 128) return launch<128, 128, Out>(c, g, sms);
    return launch<64, 128, Out>(c, g, sms);
  }
  if (bn == 256) return launch<256, 64, Out>(c, g, sms);
  if (bn == 128) return launch<128, 64, Out>(c, g, sms);
  return launch<64, 64, Out>(c, g, sms);
}

int out_size(int n, int k, int s, int p, int d) {
  return (n + 2 * p - d * (k - 1) - 1) / s + 1;
}

}  // namespace

// xq: int8 (B, H, W, Cp) contiguous (kernel Q's output), wp: int8 (Cop,
// kh*kw*Cp) contiguous (pack_weight), amax: one float32, w_scale: Co
// float32, y: (B, Ho, Wo, Co) float32 (out_bf16 0) or bfloat16 (1),
// contiguous; every pointer on the device, x and w 16-byte aligned.
extern "C" int halo_int8_conv(const void* xq, const void* wp,
                              const float* amax, const float* w_scale,
                              void* y, int out_bf16, int B, int H, int W,
                              int Cp, int Ho, int Wo, int Co, int Cop,
                              int kh, int kw, int sh, int sw, int ph, int pw,
                              int dh, int dw, float eps, float inv127,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 16 != 0 || Co <= 0 ||
      Cop < Co || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || sh > 8 ||
      sw > 8 || dh <= 0 || dw <= 0 || ph < 0 || pw < 0 ||
      Ho != out_size(H, kh, sh, ph, dh) || Wo != out_size(W, kw, sw, pw, dw) ||
      Ho <= 0 || Wo <= 0 ||
      static_cast<long long>(B) * Ho * Wo >= (1LL << 31) ||
      static_cast<long long>(B) * H * W >= (1LL << 31) ||
      static_cast<long long>(kh) * kw * Cp >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorNoDevice);
  Call c{xq, wp, amax, w_scale, y, B, H, W, Cp, Cop, kh * kw,
         static_cast<cudaStream_t>(stream)};
  Geo g{};
  g.Co = Co;
  g.kw = kw;
  g.sh = sh;
  g.sw = sw;
  g.ph = ph;
  g.pw = pw;
  g.dh = dh;
  g.dw = dw;
  g.eps = eps;
  g.inv127 = inv127;
  if (kh == 1 && kw == 1 && sh == 1 && sw == 1 && ph == 0 && pw == 0) {
    // A channel GEMM: one image of one row of M pixels.
    c.W = B * H * W;
    c.H = 1;
    c.B = 1;
    g.Ho = 1;
    g.Wo = c.W;
  } else {
    g.Ho = Ho;
    g.Wo = Wo;
  }
  // The pixel tile wasting the fewest pixels at the edges (32 x 4 first;
  // a box spans at most 256 elements of a dimension).
  g.tw_log2 = -1;
  long long fewest = 0;
  for (int lg : {5, 6, 4, 7, 3}) {
    const int tw = 1 << lg;
    const int th = kBM / tw;
    if (tw * sw > 256 || th * sh > 256) continue;
    const long long tiles = static_cast<long long>((g.Wo + tw - 1) / tw) *
                            ((g.Ho + th - 1) / th);
    if (g.tw_log2 < 0 || tiles < fewest) {
      g.tw_log2 = lg;
      fewest = tiles;
    }
  }
  g.th = kBM >> g.tw_log2;
  g.tiles_w = (g.Wo + (1 << g.tw_log2) - 1) >> g.tw_log2;
  g.tiles_h = (g.Ho + g.th - 1) / g.th;
  const long long m_tiles = fewest * c.B;
  if (m_tiles * ((Co + 63) / 64) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return dispatch<__nv_bfloat16>(c, g, static_cast<int>(m_tiles), sms);
  return dispatch<float>(c, g, static_cast<int>(m_tiles), sms);
}
