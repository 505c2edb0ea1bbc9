// Kernel Q: the activation quantise of the int8 (W8A8) path, one pass.
//
// Replaces no Pallas kernel. The JAX package quantises an activation with
// elementwise jnp ops that XLA fuses into the producer's epilogue
// (halo_tpu/ops/quant.py:68, quantize_act); in eager PyTorch the same
// ops are about eight launches a layer (upcast, divide, round, clamp,
// casts, the scale product), and kernel I (int8_conv.cu) then wanted its
// own channels-last, channel-padded copy. This kernel does all of that in
// one launch: for a float32 or bfloat16 activation x, seen as a logical
// (B, C, H, W) tensor with any element strides (NCHW, channels-last, a
// dense layer's (..., C) viewed so, the ASPP concatenation as it is), and
// the layer's calibrated absmax read from device memory (no host sync),
//   sx = max(amax, eps) * inv127            (float32: XLA's product)
//   q[b, h, w, c] = int8(clamp(rint(float(x[b, c, h, w]) / sx), -127, 127))
// with an IEEE division rounded to nearest, round half to even and the
// clamp before the conversion (so +-inf saturates), written as int8
// (B, H, W, Cp), channels zero-padded to Cp (a multiple of 16): exactly
// the operand kernel I's tensor map reads. ops/quant.py:quantize_nhwc_plain
// computes the same bits.
//
// What bounds it on an H100: bytes. It reads 2 or 4 bytes and writes one
// (plus the padding) an element, a few operations each; the R101 layer3
// input (2, 256, 80, 160) bf16 is 6.6 MB in and 3.3 MB out, ~3 us at
// 3.35 TB/s. The design serves the memory system, with one of two kernels
// a call:
//  - rows (the channels contiguous and 16-byte aligned: channels-last maps,
//    dense inputs): a thread quantises 8 channels of one pixel, one or two
//    16-byte loads and one 8-byte store, neighbouring threads on
//    neighbouring addresses; a pixel's address from its (b, h, w) once.
//  - tiles (any other strides: NCHW, the ASPP concatenation): a block
//    quantises 64 pixels x 64 channels, reading along the pixels, each
//    thread packing four channels of its pixel into a 32-bit word of a
//    shared-memory tile (odd word pitch: conflict-free), which the block
//    writes out channels-fastest, 64 bytes a pixel, coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // pixels and channels a tile block
constexpr int kThreads = 256;
constexpr int kPitch = kTile / 4 + 1;  // words a pixel row of the tile
constexpr int kVec = 8;                // channels a thread of the rows kernel

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float act_scale(const float* amax, float eps,
                                           float inv127) {
  return __fmul_rn(fmaxf(*amax, eps), inv127);
}

// int8(clamp(rint(v / sx), -127, 127)) as the low byte of a word: an IEEE
// division rounded to nearest (as torch's and XLA's), round half to even,
// the clamp before the conversion.
__device__ __forceinline__ uint32_t quantize(float v, float sx) {
  const float n = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(n))));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d,
                                          float sx) {
  return quantize(a, sx) | quantize(b, sx) << 8 | quantize(c, sx) << 16 |
         quantize(d, sx) << 24;
}

// The eight channels c .. c+7 of the pixel at px as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* px, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(px);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* px, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(px);
  const float4 b = *reinterpret_cast<const float4*>(px + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Rows: thread i quantises channels 8*(i % chunks) .. +7 of pixel
// i / chunks (chunks = Cp / 8; past C it writes zeros). kUniform: the
// pixels lie sW apart (a dense channels-last map or a dense input).
template <typename T, bool kUniform>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                     int8_t* __restrict__ q, int C, int H, int W,
                     long long sB, long long sH, long long sW, int Cp,
                     unsigned n_items, float eps, float inv127) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_items) return;
  const float sx = act_scale(amax, eps, inv127);
  const unsigned chunks = Cp / kVec;
  const unsigned p = i / chunks;
  const int c = static_cast<int>(i - p * chunks) * kVec;
  uint2 word = make_uint2(0u, 0u);
  if (c < C) {
    const T* px;
    if constexpr (kUniform) {
      px = x + p * sW;
    } else {
      const unsigned hw = H * W;
      const unsigned b = p / hw;
      const unsigned r = p - b * hw;
      const unsigned h = r / W;
      px = x + b * sB + h * sH + (r - h * W) * sW;
    }
    float v[8];
    load8(px + c, v);
    word.x = pack4(v[0], v[1], v[2], v[3], sx);
    word.y = pack4(v[4], v[5], v[6], v[7], sx);
  }
  *reinterpret_cast<uint2*>(q + static_cast<long long>(p) * Cp + c) = word;
}

// Tiles: any strides; reads along the pixels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_tile_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                     int8_t* __restrict__ q, int C, int H, int W,
                     long long sB, long long sC, long long sH, long long sW,
                     int Cp, int P, float eps, float inv127) {
  __shared__ uint32_t tile[kTile * kPitch];
  const float sx = act_scale(amax, eps, inv127);
  const int p0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  const int t = threadIdx.x;
  // Thread t: pixel pl, the words wd = t / 64 + 4i (channels 4*wd ..).
  const int pl = t % kTile;
  const int p = p0 + pl;
  const T* px = x;
  if (p < P) {
    const int hw = H * W;
    const int b = p / hw;
    const int r = p - b * hw;
    const int h = r / W;
    const int w = r - h * W;
    px = x + b * sB + h * sH + w * sW;
  }
#pragma unroll
  for (int i = 0; i < kTile / 4 / (kThreads / kTile); ++i) {
    const int wd = t / kTile + i * (kThreads / kTile);
    uint32_t word = 0;
    if (p < P) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 4 * wd + k;
        if (c < C) word |= quantize(load_float(px + c * sC), sx) << (8 * k);
      }
    }
    tile[pl * kPitch + wd] = word;
  }
  __syncthreads();
  // Out: 16 threads a pixel, one word each: 64 contiguous bytes.
#pragma unroll
  for (int i = 0; i < kTile / (kThreads / (kTile / 4)); ++i) {
    const int ol = t / (kTile / 4) + i * (kThreads / (kTile / 4));
    const int wd = t % (kTile / 4);
    const int op = p0 + ol;
    const int c = c0 + 4 * wd;
    if (op < P && c < Cp)
      *reinterpret_cast<uint32_t*>(q + static_cast<long long>(op) * Cp + c) =
          tile[ol * kPitch + wd];
  }
}

template <typename T>
int launch(const T* x, const float* amax, int8_t* q, int B, int C, int H,
           int W, long long sB, long long sC, long long sH, long long sW,
           int Cp, float eps, float inv127, cudaStream_t s) {
  const long long P = static_cast<long long>(B) * H * W;
  // 16-byte loads of 8 channels: contiguous channels, C a multiple of 8,
  // every pixel 16-byte aligned.
  const long long align = 16 / sizeof(T);
  const bool rows = sC == 1 && C % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    sB % align == 0 && sH % align == 0 && sW % align == 0;
  if (rows) {
    const unsigned items = static_cast<unsigned>(P * (Cp / kVec));
    const unsigned blocks = (items + kThreads - 1) / kThreads;
    const bool uniform = (H == 1 || sH == W * sW) &&
                         (B == 1 || sB == static_cast<long long>(H) * W * sW);
    if (uniform)
      quantize_rows_kernel<T, true><<<blocks, kThreads, 0, s>>>(
          x, amax, q, C, H, W, sB, sH, sW, Cp, items, eps, inv127);
    else
      quantize_rows_kernel<T, false><<<blocks, kThreads, 0, s>>>(
          x, amax, q, C, H, W, sB, sH, sW, Cp, items, eps, inv127);
  } else {
    const dim3 grid(static_cast<unsigned>((P + kTile - 1) / kTile),
                    (Cp + kTile - 1) / kTile);
    quantize_tile_kernel<T><<<grid, kThreads, 0, s>>>(
        x, amax, q, C, H, W, sB, sC, sH, sW, Cp, static_cast<int>(P), eps,
        inv127);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: a float32 (x_bf16 0) or bfloat16 (1) tensor read as (B, C, H, W) with
// element strides (sB, sC, sH, sW); amax: one float32 on the device; q:
// int8 (B, H, W, Cp) contiguous, Cp >= C a multiple of 16, 16-byte
// aligned.
extern "C" int halo_int8_quantize(const void* x, int x_bf16,
                                  const float* amax, void* q, int B, int C,
                                  int H, int W, long long sB, long long sC,
                                  long long sH, long long sW, int Cp,
                                  float eps, float inv127, void* stream) {
  const long long P = static_cast<long long>(B) * H * W;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || Cp < C || Cp % 16 != 0 ||
      P + kTile >= (1LL << 31) || P * (Cp / kVec) >= (1LL << 31) ||
      (Cp + kTile - 1) / kTile > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* out = static_cast<int8_t*>(q);
  if (x_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), amax, out, B, C, H,
                  W, sB, sC, sH, sW, Cp, eps, inv127, s);
  return launch(static_cast<const float*>(x), amax, out, B, C, H, W, sB, sC,
                sH, sW, Cp, eps, inv127, s);
}
