// Kernel B: per-pixel Poincare distance to the origin (the 'radius' map).
//
// Replaces the TPU kernel radius_map (halo_tpu/active/pallas_radius.py:100,
// body _radius_kernel_3d at :79): for an (H, W, C) embedding,
//   out[p] = (2/sqrt(c)) * artanh(clip(sqrt(c) * sqrt(max(sum_k x[p,k]^2,
//                                                   1e-30)), 1 - 1e-7))
// with float32 squares and sums, i.e. dist0(x.float()).
//
// What bounds it on an H100: bytes. It reads C values per pixel and writes
// one float, doing ~2 flops per byte read: at 1024x2048x64 bf16 that is
// 268 MB in and 8.4 MB out, ~83 us at 3.35 TB/s, while the arithmetic is
// negligible. The design serves the memory system only: eight threads per
// pixel, each loading 16 bytes at a time (one 128-byte line per pixel at
// C=64 bf16, neighbouring threads on neighbouring addresses), squares and
// sums in float32 registers, a three-step shuffle reduction across the
// eight lanes, and one store per pixel. No shared memory, no atomics.
// Rows whose length or alignment does not allow 16-byte loads take a
// scalar loop in the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerPixel = 8;
constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = kThreads / kLanesPerPixel;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// Sum of squares of one 16-byte chunk.
__device__ __forceinline__ float chunk_sq(uint4 raw, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}
__device__ __forceinline__ float chunk_sq(uint4 raw, const float*) {
  const float* p = reinterpret_cast<const float*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s = fmaf(p[i], p[i], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
radius_kernel(const T* __restrict__ x, float* __restrict__ out,
              long long n_pix, int channels, int vectorized, float sqrt_c,
              float two_over_sqrt_c) {
  const long long pix =
      (long long)blockIdx.x * kPixelsPerBlock + threadIdx.x / kLanesPerPixel;
  const int lane = threadIdx.x % kLanesPerPixel;
  float s = 0.f;
  if (pix < n_pix) {
    const T* row = x + pix * channels;
    if (vectorized) {
      constexpr int kElems = 16 / sizeof(T);
      const uint4* vrow = reinterpret_cast<const uint4*>(row);
      const int chunks = channels / kElems;
      for (int j = lane; j < chunks; j += kLanesPerPixel)
        s += chunk_sq(vrow[j], row);
    } else {
      for (int k = lane; k < channels; k += kLanesPerPixel) {
        const float v = to_float(row[k]);
        s = fmaf(v, v, s);
      }
    }
  }
  // Every lane of the warp takes part, in range or not.
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (pix < n_pix && lane == 0) {
    const float kHi = static_cast<float>(1.0 - 1e-7);
    const float norm = sqrtf(fmaxf(s, 1e-30f));
    const float t = fminf(fmaxf(sqrt_c * norm, -kHi), kHi);
    out[pix] = two_over_sqrt_c * atanhf(t);
  }
}

template <typename T>
int launch(const void* x, float* out, long long n_pix, int channels,
           int vectorized, float sqrt_c, float two_over_sqrt_c,
           void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_pix + kPixelsPerBlock - 1) / kPixelsPerBlock;
  radius_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), out, n_pix, channels, vectorized, sqrt_c,
      two_over_sqrt_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int halo_radius_map_bf16(const void* x, float* out,
                                    long long n_pix, int channels,
                                    int vectorized, float sqrt_c,
                                    float two_over_sqrt_c, void* stream) {
  return launch<__nv_bfloat16>(x, out, n_pix, channels, vectorized, sqrt_c,
                               two_over_sqrt_c, stream);
}

extern "C" int halo_radius_map_f32(const void* x, float* out, long long n_pix,
                                   int channels, int vectorized, float sqrt_c,
                                   float two_over_sqrt_c, void* stream) {
  return launch<float>(x, out, n_pix, channels, vectorized, sqrt_c,
                       two_over_sqrt_c, stream);
}
