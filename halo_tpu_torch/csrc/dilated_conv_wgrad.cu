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
// What bounds it on an H100: operations. Each tap is a GEMM with M = C,
// N = Co and a long K = B*H*W: 2*9*C*Co*B*H*W FLOP, 34.0 GFLOP at layer3
// of the R101 trunk (B = 2, 90x160, C = Co = 256) against ~15 MB read,
// far above the ~295 FLOP/byte bf16 ridge: 0.034 ms at 989 TFLOP/s, 0.137
// ms for 512 channels. The output is small (9 x 256 x 256) and K is long,
// so the card is filled by splitting K.
//
// Design: TMA + wgmma, warp-specialised like the forward kernel.
//  - A tile is 128 input channels x 256 output channels of one tap, two
//    consumer warpgroups of 64 channels each (wgmma m64n256k16, float32
//    accumulators in registers). A pipeline step is 64 pixels: a 32 x 2
//    patch of one image.
//  - Operands by TMA with no padded or shifted copy: A is two boxes
//    (64 channels, 32 w, 2 h, 1) of a 4-D map over x at the tap's shifted
//    coordinates, so TMA's zero fill does the padding margin, the ragged
//    H/W edges and channels past C; B is four such boxes of a map over g
//    at the unshifted coordinates (a pixel past H or W reads a zero of g
//    and adds nothing). A box lands as 64 rows of 128 bytes, one pixel a
//    row, 128B-swizzled: the MN-major layout that wgmma reads for bf16
//    through its transpose bits (sw128_mn_desc: 8-pixel groups 1024 bytes
//    apart, 64-channel blocks one box (8 KB) apart).
//  - One producer thread keeps a ring of 4 stages (48 KB each) in flight
//    against full/empty mbarriers; setmaxnreg moves registers to the
//    consumers.
//  - Split-K, stream-K style: the (tile, pixel step) units of all nine
//    taps are laid out tile-major and one wave of blocks (one an SM) takes
//    equal contiguous ranges of them. A block accumulates in registers
//    while its range stays in one tile and writes a float32 partial tile
//    (128 KB) to a workspace slot each time it leaves one: slot
//    block + tile, unique because each step along a range moves the block
//    or the tile index on. At layer3 18 tiles of 450 steps each are 61 or
//    62 steps a block; at 512 channels 72 tiles, 245 or 246.
//  - A deterministic reduction: a second kernel sums each tile's partials
//    in block order (no atomics; two calls give the same bits), rounds to
//    bf16 and writes dk in the (Co, C, 3, 3) layout through a shared
//    transpose, so no stack, permute or cast follows. The workspace is
//    (blocks + tiles) x 128 KB: 19.7 MB at layer3 (150 slots), 26.7 MB
//    at 512 channels (204), written once and read once, mostly in L2.

#include "dilated_conv.cuh"

namespace {

constexpr int kPW = 32;                // a pixel step: 2 rows of 32 pixels
constexpr int kPH = 2;
constexpr int kPK = kPW * kPH;         // 64 pixels: the K of a step
constexpr int kTM = 128;               // input channels a tile
constexpr int kTN = 256;               // output channels a tile
constexpr int kStages = 4;
constexpr int kBoxBytes = 64 * kPK * 2;            // 64 channels x 64 pixels
constexpr int kABytes = (kTM / 64) * kBoxBytes;    // 16 KB
constexpr int kBBytes = (kTN / 64) * kBoxBytes;    // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + align
constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kAlign = 32;             // the C and Co rule (supports())
constexpr int kTileFloats = kTM * kTN;
constexpr int kRCi = 8;                // reduce block: 8 input channels
constexpr int kRO = 32;                // x 32 output channels
constexpr int kRPitch = 9 * kRCi + 2;  // bf16: an odd number of words

static_assert(kTM == 2 * 64, "two consumer warpgroups of 64 channels");
static_assert(kTM % kRCi == 0 && kTN % kRO == 0, "a reduce block in a tile");
static_assert(kRCi * kRO == 256, "a thread a (c, o) pair");

// The block whose contiguous range of the U units holds unit u, when G
// blocks take [b*U/G, (b+1)*U/G).
__host__ __device__ __forceinline__ int block_of(long long u, long long U,
                                                 int G) {
  return static_cast<int>(((u + 1) * G - 1) / U);
}

__global__ void __launch_bounds__(kThreads, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_g,
                  float* __restrict__ ws, int d, int tiles_w, int tiles_h,
                  int KT, int NT, long long U) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full_bar = base + kBarOffset;       // kStages x 8 bytes
  const uint32_t empty_bar = full_bar + kStages * 8;  // kStages x 8 bytes
  const int wg = threadIdx.x / 128;
  const long long u_begin = blockIdx.x * U / gridDim.x;
  const long long u_end = (blockIdx.x + 1LL) * U / gridDim.x;

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
      for (long long u = u_begin; u < u_end; ++u, ++it) {
        const int tile = static_cast<int>(u / KT);
        const int kt = static_cast<int>(u % KT);
        const int tap = tile % 9;
        const int m0 = (tile / 9 / NT) * kTM;
        const int n0 = (tile / 9 % NT) * kTN;
        const int w0 = (kt % tiles_w) * kPW;
        const int h0 = (kt / tiles_w % tiles_h) * kPH;
        const int b = kt / tiles_w / tiles_h;
        const int xw = w0 + (tap % 3 - 1) * d;
        const int xh = h0 + (tap / 3 - 1) * d;
        const int s = it % kStages;
        mbar_wait(empty_bar + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t dst = base + s * kStageBytes;
        const uint32_t bar = full_bar + 8 * s;
        mbar_expect_tx(bar, kStageBytes);
#pragma unroll
        for (int a = 0; a < kTM / 64; ++a)
          tma_load_4d(dst + a * kBoxBytes, &tm_x, bar, m0 + 64 * a, xw, xh,
                      b);
#pragma unroll
        for (int q = 0; q < kTN / 64; ++q)
          tma_load_4d(dst + kABytes + q * kBoxBytes, &tm_g, bar, n0 + 64 * q,
                      w0, h0, b);
      }
    }
  } else {
    // Consumers: warpgroup cw owns input channels cw*64 .. cw*64+63 of a
    // tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    int it = 0;
    long long u = u_begin;
    while (u < u_end) {
      const int tile = static_cast<int>(u / KT);
      const long long seg_end =
          min(u_end, static_cast<long long>(tile + 1) * KT);
      float acc[kTN / 2];
#pragma unroll
      for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
      for (int step = 0; u < seg_end; ++u, ++it, ++step) {
        const int s = it % kStages;
        mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
        const uint32_t a = base + s * kStageBytes + cw * kBoxBytes;
        const uint32_t bb = base + s * kStageBytes + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kPK / 16; ++kk)  // 16 pixels: 2 row groups
          wgmma_m64n256k16<1, 1>(acc,
                                 sw128_mn_desc(a + kk * 2048, kBoxBytes),
                                 sw128_mn_desc(bb + kk * 2048, kBoxBytes),
                                 (step > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products have read their stage
        fence_acc(acc);
        if (step > 0 && lane == 0)
          mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));

      // The partial tile to slot blockIdx.x + tile, rows = input channels,
      // columns = output channels. Register 4j+q holds row warp*16 +
      // lane/4 (+8 for q >= 2), column 8j + 2*(lane%4) + (q&1): each store
      // writes whole 32-byte sectors.
      float* row = ws + (static_cast<long long>(blockIdx.x + tile) * kTM +
                         cw * 64 + warp * 16 + lane / 4) *
                            kTN +
                   2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j) {
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(row + 8 * kTN + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// dk[o, c, tap] = bf16(sum over the blocks b of tile(c, o, tap), in block
// order, of ws[slot b + tile][c % 128][o % 256]). A block of 256 threads
// takes 8 input x 32 output channels and all nine taps, a thread one
// (c, o) pair: its nine sums are independent, so each round of the slot
// loop has nine loads in flight (the reduction is bound by the latency of
// its workspace reads, not their bytes). The (o, c, tap) rows go out
// through shared memory, 72 contiguous bf16 each.
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ ws,
                    __nv_bfloat16* __restrict__ dk, int C, int KT, int NT,
                    long long U, int G) {
  __shared__ __align__(16) __nv_bfloat16 sm[kRO * kRPitch];
  const int c0 = blockIdx.x * kRCi;
  const int o0 = blockIdx.y * kRO;
  const int ol = threadIdx.x % kRO;  // a warp reads 128 contiguous bytes
  const int cl = threadIdx.x / kRO;
  const int mn = (c0 / kTM) * NT + o0 / kTN;
  const float* p[9];
  int n[9];
  int rounds = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int tile = mn * 9 + tap;
    const int b_lo = block_of(static_cast<long long>(tile) * KT, U, G);
    const int b_hi = block_of(static_cast<long long>(tile + 1) * KT - 1, U, G);
    p[tap] = ws + (static_cast<long long>(b_lo + tile) * kTM +
                   (c0 + cl) % kTM) *
                      kTN +
             (o0 + ol) % kTN;
    n[tap] = b_hi - b_lo + 1;
    rounds = max(rounds, n[tap]);
  }
  float sum[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) sum[tap] = 0.f;
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      if (i < n[tap]) sum[tap] += p[tap][static_cast<long long>(i) *
                                         kTileFloats];
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    sm[ol * kRPitch + cl * 9 + tap] = __float2bfloat16_rn(sum[tap]);
  __syncthreads();
  constexpr int kPairs = 9 * kRCi / 2;  // bf16 pairs of a row
  for (int i = threadIdx.x; i < kRO * kPairs; i += 256) {
    const int r = i / kPairs;
    const int col = i % kPairs;
    *reinterpret_cast<__nv_bfloat162*>(
        dk + (static_cast<long long>(o0 + r) * C + c0) * 9 + 2 * col) =
        *reinterpret_cast<const __nv_bfloat162*>(sm + r * kRPitch + 2 * col);
  }
}

// The split of one call: G blocks over U = 9 * MT * NT * KT units.
struct Plan {
  int tiles_w, tiles_h, KT, MT, NT, G;
  long long U, ws_bytes;
};

bool make_plan(int B, int H, int W, int C, int Co, int d, Plan* p) {
  if (!shape_ok(B, H, W, C, Co, d, kAlign)) return false;
  const int sms = sm_count();
  if (sms == 0) return false;
  p->tiles_w = (W + kPW - 1) / kPW;
  p->tiles_h = (H + kPH - 1) / kPH;
  p->KT = B * p->tiles_h * p->tiles_w;
  p->MT = (C + kTM - 1) / kTM;
  p->NT = (Co + kTN - 1) / kTN;
  const long long tiles = 9LL * p->MT * p->NT;
  p->U = tiles * p->KT;
  p->G = static_cast<int>(p->U < sms ? p->U : sms);
  p->ws_bytes = (p->G + tiles - 1) * kTileFloats * 4LL;
  return true;
}

}  // namespace

// Bytes of float32 workspace that halo_dilated_conv3x3_wgrad_bf16 needs
// for these shapes on the current device; -1 for shapes it refuses.
extern "C" long long halo_dilated_conv3x3_wgrad_workspace(int B, int H, int W,
                                                          int C, int Co,
                                                          int d) {
  Plan p;
  return make_plan(B, H, W, C, Co, d, &p) ? p.ws_bytes : -1;
}

// x: (B, H, W, C) bf16; g: (B, H, W, Co) bf16; dk: (Co, C, 3, 3) bf16;
// ws: float32 scratch of ws_bytes (the workspace entry's count). All
// contiguous, x and g 16-byte aligned.
extern "C" int halo_dilated_conv3x3_wgrad_bf16(const void* x, const void* g,
                                               void* dk, void* ws,
                                               long long ws_bytes, int B,
                                               int H, int W, int C, int Co,
                                               int d, void* stream) {
  Plan p;
  if (!make_plan(B, H, W, C, Co, d, &p) || ws_bytes < p.ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_x, tm_g;
  if (!encode_nhwc_map(fn, &tm_x, x, B, H, W, C, kPW, kPH) ||
      !encode_nhwc_map(fn, &tm_g, g, B, H, W, Co, kPW, kPH))
    return static_cast<int>(cudaErrorInvalidValue);
  // Once a process: the shared-memory opt-in.
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_bf16_kernel<<<p.G, kThreads, kSmemBytes, s>>>(
      tm_x, tm_g, static_cast<float*>(ws), d, p.tiles_w, p.tiles_h, p.KT,
      p.NT, p.U);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_reduce_kernel<<<dim3(C / kRCi, Co / kRO), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dk), C,
      p.KT, p.NT, p.U, p.G);
  return static_cast<int>(cudaGetLastError());
}
