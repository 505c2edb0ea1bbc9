// Kernel C: dense 3x3 convolution, stride 1, padding d, dilation d.
//
// Replaces the TPU kernel dilated_conv3x3 (halo_tpu/ops/pallas_conv.py:150,
// _conv_impl :118, body _kernel :103). For a channels-last input x
// (B, H, W, C) and a weight repacked tap-major as w9 (9, C, Co), with the
// tap (i, j) reading the input shifted by ((i - 1) d, (j - 1) d):
//   y[b,h,w,o] = sum_{i,j,c} x[b, h + (i-1)d, w + (j-1)d, c] w9[3i+j, c, o]
// where reads outside the image are zeros, accumulated in float32 and
// stored once in the input's dtype. The same kernel computes the input
// gradient of that convolution when given the cotangent and the flipped,
// IO-transposed weight (the wrapper repacks it; pallas_conv.py:166-175).
//
// What bounds it on an H100: operations. A layer3 call of the R101 trunk
// (B = 2, 90x160, C = Co = 256) is 2*2*90*160*9*256*256 = 34.0 GFLOP
// against ~15 MB read and written, ~2300 FLOP a byte, far above the card's
// ~295 FLOP/byte bf16 ridge: its bound is 34.0 GFLOP / 989 TFLOP/s =
// 0.034 ms, and 0.137 ms for a 512-channel layer4 call.
//
// Design: an implicit GEMM. The TPU kernel kept one image's whole padded
// input (7 MB) in VMEM; an SM has 227 KB, so here each block computes one
// (128 pixels x 128 output channels) tile and walks the reduction over
// 9 taps x C in steps of 32 channels. Each step stages an A tile (128
// pixels x 32 channels of one tap's shifted read, gathered straight from
// the channels-last input; a pixel whose tap falls in the padding margin
// is zero-filled by cp.async, so no padded copy is ever made) and a B tile
// (32 channels x 128 outputs of that tap) in shared memory, three stages
// deep with cp.async so that loads overlap the products. Eight warps each
// own a 32x64 sub-tile of 2x4 wmma 16x16x16 bf16 fragments with float32
// accumulators. The epilogue goes through shared memory so that every
// thread stores 16 contiguous bytes, and the output is cast to bf16 once.
// wgmma, TMA and warp specialisation are left for a later version.
//
// A float32 instantiation (TPU.COMPUTE_DTYPE float32) runs the same
// gather as a plain SIMT tile (64x64, 4x4 outputs a thread, float32 FMAs,
// no TF32), so the f32 path stays f32 as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128;       // pixels a block
constexpr int kBN = 128;       // output channels a block
constexpr int kBK = 32;        // input channels a reduction step
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 4 (pixels) x 2 (channels)
constexpr int kALd = kBK + 8;  // padded shared-memory rows (elements)
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr int kPipeBytes = kStages * (kAStage + kBStage) * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w9,
                 __nv_bfloat16* __restrict__ y, int B, int H, int W, int C,
                 int Co, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kStages * kAStage;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;  // rows warp_m*32 .. +32
  const int warp_n = warp % 2;  // cols warp_n*64 .. +64
  const int M = B * H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // This thread's two A rows (pixels) and its 16-byte column chunk.
  const int a_col = (tid % 4) * 8;
  int a_b[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + tid / 4 + r * 64;
    a_ok[r] = m < M;
    const int mm = a_ok[r] ? m : 0;
    a_w[r] = mm % W;
    a_h[r] = (mm / W) % H;
    a_b[r] = mm / (W * H);
  }
  // This thread's two B rows (input channels) and its column chunk.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 8;
  const bool b_ok = n0 + b_col < Co;

  const int k_steps = C / kBK;
  const int total = 9 * k_steps;

  auto load_stage = [&](int stage, int step) {
    const int tap = step / k_steps;
    const int k0 = (step % k_steps) * kBK;
    const int dh = (tap / 3 - 1) * d;
    const int dw = (tap % 3 - 1) * d;
    __nv_bfloat16* a_dst = As + stage * kAStage;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = a_h[r] + dh;
      const int ww = a_w[r] + dw;
      const bool ok = a_ok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src =
          ok ? x + ((static_cast<long long>(a_b[r]) * H + hh) * W + ww) * C +
                   k0 + a_col
             : x;
      cp_async16(a_dst + (tid / 4 + r * 64) * kALd + a_col, src, ok);
    }
    __nv_bfloat16* b_dst = Bs + stage * kBStage;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = b_row + r * 16;
      const __nv_bfloat16* src =
          b_ok ? w9 + (static_cast<long long>(tap) * C + k0 + row) * Co + n0 +
                     b_col
               : w9;
      cp_async16(b_dst + row * kBLd + b_col, src, b_ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed; stage `step - 1` is free
    const int next = step + kStages - 1;
    if (next < total) load_stage(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* a_src = As + (step % kStages) * kAStage;
    const __nv_bfloat16* b_src = Bs + (step % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], a_src + (warp_m * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], b_src + kk * kBLd + warp_n * 64 + j * 16,
                               kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the epilogue's

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * kCLd + warp_n * 64 + j * 16,
          acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();

  // 128 rows x 16 chunks of 8 outputs; 8 chunks a thread.
#pragma unroll
  for (int it = 0; it < (kBM * kBN / 8) / kThreads; ++it) {
    const int chunk = tid + it * kThreads;
    const int r = chunk / (kBN / 8);
    const int c = (chunk % (kBN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < Co) {
      const float* src = Cs + r * kCLd + c;
      __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        packed[q] = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
      *reinterpret_cast<uint4*>(y + static_cast<long long>(m) * Co + n) =
          *reinterpret_cast<const uint4*>(packed);
    }
  }
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

extern "C" int halo_dilated_conv3x3_bf16(const void* x, const void* w9,
                                         void* y, int B, int H, int W, int C,
                                         int Co, int d, void* stream) {
  if (!shape_ok(B, H, W, C, Co, d, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * H * W;
  dim3 grid((M + kBM - 1) / kBM, (Co + kBN - 1) / kBN);
  conv_bf16_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w9), static_cast<__nv_bfloat16*>(y),
      B, H, W, C, Co, d);
  return static_cast<int>(cudaGetLastError());
}

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
