// The int8 (W8A8) convolution of the quantised evaluation path.
//
// Replaces no Pallas kernel. The JAX package's int8 conv
// (halo_tpu/ops/quant.py:81, int8_conv) is one XLA convolution of int8
// operands with int32 accumulation; PyTorch has no int8 convolution on
// CUDA (F.conv2d takes no integer tensors there, and cuDNN's int8 paths
// are not exposed), and a loop of kh*kw torch._int_mm calls over shifted,
// padded copies would move the activation kh*kw times. So the port
// carries this kernel for every quantised conv that is not a 1x1 channel
// GEMM: the ResNet trunk's 3x3 convs (dilation 1, 2, 4; layer2's first
// with stride 2), the DeepLab-v3+ ASPP bottleneck and MiT's 3x3 stride-2
// patch embedding.
//
// What it computes, for an NHWC int8 input x (channels padded with zeros
// to a multiple of 16), a K-major int8 weight w (Co, kh*kw*C: tap outer,
// input channel inner) and a float32 per-output-channel scale
// (sx * w_scale):
//   y[n, ho, wo, co] = float(sum_{i, j, c} x[n, ho*sh - ph + i*dh,
//                                             wo*sw - pw + j*dw, c]
//                                           * w[co, (i*kw + j)*C + c])
//                      * scale[co]
// with zero padding (exact: the quantisation is symmetric), int32 sums
// (exact), one float32 multiply rounded to nearest, written as float32 or
// rounded once more to bfloat16. The plain version
// (ops/quant.py:int8_conv_plain) computes the same bits.
//
// What bounds it on an H100: operations. A 3x3 conv at 256 channels does
// 2*9*256 = 4608 integer operations per output value against 256 bytes of
// input read per pixel: at 1,979 TOPS int8 and 3.35 TB/s the tensor cores
// are the limit above ~590 operations a byte. The design is the simple
// right one for this PR: an implicit GEMM over (pixels x output channels)
// with K = taps x channels, 128 x BN tiles (BN 128, or 64 for narrow
// outputs), K steps of 64 bytes, a 4-stage cp.async ring whose 16-byte
// copies zero-fill the padding margin and the ragged edges, ldmatrix
// fragments and mma.sync m16n8k32 s8 x s8 -> s32, eight warps a block.
// Hopper's s8 wgmma with TMA (and the activation quantise fused into the
// loads) is later work (ROADMAP Queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // output pixels a block
constexpr int kBK = 64;                  // bytes of K a stage
constexpr int kRow = kBK + 16;           // smem row pitch: conflict-free
constexpr int kStages = 4;
constexpr int kThreads = 256;            // eight warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 writes zeros (padding, ragged edges).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geometry {
  int B, H, W, C;          // input, NHWC; C a multiple of 16
  int Ho, Wo, Co;          // output, NHWC
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int M;                   // B * Ho * Wo
  int K;                   // kh * kw * C
  int cblocks;             // ceil(C / kBK)
};

__device__ __forceinline__ void store2(float* y, long long off, float v0,
                                       float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
  } else {
    y[off] = v0;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, long long off,
                                       float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(y + off) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    y[off] = __float2bfloat16_rn(v0);
  }
}

// Block: kBM pixels x BN output channels; warps WM x WN.
template <int BN, int WM, typename Out>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, Out* __restrict__ y,
                 Geometry g) {
  constexpr int WN = 8 / WM;
  constexpr int WTM = kBM / WM;          // warp tile rows
  constexpr int WTN = BN / WN;           // warp tile columns
  constexpr int MI = WTM / 16;
  constexpr int NI = WTN / 8;
  static_assert(NI % 2 == 0, "B fragments load in pairs of n8 blocks");
  constexpr int A_BYTES = kBM * kRow;
  constexpr int STAGE = (kBM + BN) * kRow;
  constexpr int A_LOADS = kBM * (kBK / 16) / kThreads;   // 2
  constexpr int B_LOADS = BN * (kBK / 16) / kThreads;    // 2 or 1

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % WM;
  const int warp_n = warp / WM;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int chunk = (tid & 3) * 16;      // this thread's 16 bytes of a row

  // The pixels whose A rows this thread copies: their image and the input
  // coordinates of tap (0, 0).
  int a_img[A_LOADS], a_h[A_LOADS], a_w[A_LOADS];
  bool a_ok[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int m = m0 + (tid >> 2) + i * (kThreads / 4);
    a_ok[i] = m < g.M;
    const int mm = a_ok[i] ? m : 0;
    const int wo = mm % g.Wo;
    const int t = mm / g.Wo;
    a_img[i] = t / g.Ho;
    a_h[i] = (t % g.Ho) * g.sh - g.ph;
    a_w[i] = wo * g.sw - g.pw;
  }

  const int k_tiles = g.kh * g.kw * g.cblocks;

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / g.cblocks;
    const int c = (kt - tap * g.cblocks) * kBK + chunk;
    const int ti = tap / g.kw;
    const int tj = tap - ti * g.kw;
    unsigned char* base = smem + stage * STAGE;
    const bool c_ok = c < g.C;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int row = (tid >> 2) + i * (kThreads / 4);
      const int ih = a_h[i] + ti * g.dh;
      const int iw = a_w[i] + tj * g.dw;
      const bool ok = a_ok[i] && c_ok && ih >= 0 && ih < g.H && iw >= 0 &&
                      iw < g.W;
      const int8_t* src =
          ok ? x + ((static_cast<long long>(a_img[i]) * g.H + ih) * g.W +
                    iw) * g.C + c
             : x;
      cp_async16(smem_u32(base + row * kRow + chunk), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int row = (tid >> 2) + i * (kThreads / 4);
      const int co = n0 + row;
      const bool ok = co < g.Co && c_ok;
      const int8_t* src =
          ok ? w + static_cast<long long>(co) * g.K + tap * g.C + c : w;
      cp_async16(smem_u32(base + A_BYTES + row * kRow + chunk), src,
                 ok ? 16 : 0);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free to refill
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const unsigned char* base = smem + (kt % kStages) * STAGE;
    const uint32_t a_base = smem_u32(base);
    const uint32_t b_base = smem_u32(base + A_BYTES);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = warp_m * WTM + i * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 16;
        ldmatrix_x4(a_base + row * kRow + col, a[i][0], a[i][1], a[i][2],
                    a[i][3]);
      }
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        const int row = warp_n * WTN + j * 8 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(b_base + row * kRow + col, b[j][0], b[j][1],
                    b[j + 1][0], b[j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: float(sum) * scale[co], rounded once into the output dtype.
  const int group = lane >> 2;
  const int quad = lane & 3;
  const bool even_co = (g.Co & 1) == 0;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int co = n0 + warp_n * WTN + j * 8 + quad * 2;
    if (co >= g.Co) continue;
    const bool pair = co + 1 < g.Co && even_co;
    const float s0 = scale[co];
    const float s1 = co + 1 < g.Co ? scale[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * WTM + i * 16 + group + half * 8;
        if (m >= g.M) continue;
        const float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * half]), s0);
        const float v1 =
            __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s1);
        const long long off = static_cast<long long>(m) * g.Co + co;
        store2(y, off, v0, v1, pair);
        if (!pair && co + 1 < g.Co) store2(y, off + 1, v1, 0.f, false);
      }
    }
  }
}

template <int BN, int WM, typename Out>
int launch(const Geometry& g, const void* x, const void* w,
           const float* scale, void* y, cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kRow;
  auto kernel = int8_conv_kernel<BN, WM, Out>;
  // Once a process for each instantiation: the opt-in above 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((g.M + kBM - 1) / kBM, (g.Co + BN - 1) / BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<Out*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int dispatch(const Geometry& g, const void* x, const void* w,
             const float* scale, void* y, cudaStream_t stream) {
  // Narrow outputs (layer1's 64 channels) take 64-wide tiles.
  if (g.Co <= 64) return launch<64, 4, Out>(g, x, w, scale, y, stream);
  return launch<128, 2, Out>(g, x, w, scale, y, stream);
}

}  // namespace

extern "C" int halo_int8_conv(const void* x, const void* w,
                              const float* scale, void* y, int out_bf16,
                              int B, int H, int W, int C, int Ho, int Wo,
                              int Co, int kh, int kw, int sh, int sw, int ph,
                              int pw, int dh, int dw, void* stream) {
  Geometry g{B, H, W, C, Ho, Wo, Co, kh, kw, sh, sw, ph, pw, dh, dw,
             0, 0, 0};
  const long long m = static_cast<long long>(B) * Ho * Wo;
  const long long k = static_cast<long long>(kh) * kw * C;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || Ho <= 0 ||
      Wo <= 0 || Co <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      dh <= 0 || dw <= 0 || ph < 0 || pw < 0 || m >= (1LL << 31) ||
      k >= (1LL << 31) || (m + kBM - 1) / kBM >= (1LL << 31) ||
      (Co + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  g.M = static_cast<int>(m);
  g.K = static_cast<int>(k);
  g.cblocks = (C + kBK - 1) / kBK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return dispatch<__nv_bfloat16>(g, x, w, scale, y, s);
  return dispatch<float>(g, x, w, scale, y, s);
}
