// Kernel A: greedy region picks on one score map.
//
// Replaces the TPU kernel pallas_greedy_picks
// (halo_tpu/active/pallas_select.py:119, body _select_kernel at :50). For
// num_picks rounds: take the global argmax of the score map with torch's
// first-occurrence tie-break (smallest column w, then smallest row h),
// record (h, w), set rows |row-h| <= m of columns w-m..w+m to -inf, and
// carry on. An all -inf map ends the picks; the rest of the list is -1.
// The kernel only compares floats and never does arithmetic on them, so it
// is bit-exact with the plain version (cuda_select.greedy_picks_reference)
// or wrong.
//
// What bounds it on an H100: latency, not bytes. The least traffic is one
// read of the 8 MB map (1024x2048 f32), ~2.5 us at 3.35 TB/s; the column
// cache re-reads (2m+1) columns of H floats per pick, 2331*11*4 KB = 105 MB
// (~31 us) at the recipe's shapes. But the picks form one serial chain:
// every pick needs the previous pick's suppression, so the time is the
// chain's length times the latency of one step.
//
// The design keeps each step short and inside one SM. One thread block of
// 1024 threads runs the whole loop; nothing leaves the block, so steps are
// joined by __syncthreads, not by kernel launches or grid barriers. The
// wrapper hands over a scratch copy of the map transposed to (W, H), so a
// column is contiguous and a warp reads it with coalesced loads; at
// 1024x2048 it is 8 MB and stays in the 50 MB L2. The per-column
// (max, first-argmax-row) cache lives in dynamic shared memory (8 bytes a
// column: 16 KB at W = 2048). A pick is a block-wide argmax over the cache
// (two levels of warp shuffles), a (2m+1)^2 write of -inf, and a
// re-reduction of the <= 2m+1 touched columns, one warp per column.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one value per lane of warp 0

// (v, i) <- (v2, i2) when v2 is greater, or equal with a smaller index.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, v2, i2);
  }
}

// (max, first argmax row) of one contiguous column, by one whole warp. The
// sentinel row h loses every tie, so an all -inf column gives (-inf, 0),
// as jnp.argmax does. Plain (not read-only) loads: the block writes the
// map between reductions.
__device__ __forceinline__ void reduce_column(const float* col, int h,
                                              int lane, float& v, int& r) {
  v = -CUDART_INF_F;
  r = h;
#pragma unroll 4
  for (int row = lane; row < h; row += 32) take_better(v, r, col[row], row);
  warp_argmax(v, r);
}

__global__ void __launch_bounds__(kThreads)
greedy_picks_kernel(float* score_t, int h, int w, int num_picks, int m,
                    int* picks, int* count) {
  extern __shared__ float cache[];
  float* colmax = cache;
  int* colrow = reinterpret_cast<int*>(cache + w);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_w;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mw = 2 * m + 1;

  for (int c = warp; c < w; c += kWarps) {
    float v;
    int r;
    reduce_column(score_t + (size_t)c * h, h, lane, v, r);
    if (lane == 0) {
      colmax[c] = v;
      colrow[c] = r;
    }
  }
  __syncthreads();

  int n = 0;
  for (int i = 0; i < num_picks; ++i) {
    // Block argmax over the column cache.
    float v = -CUDART_INF_F;
    int c = w;
    for (int j = tid; j < w; j += kThreads) take_better(v, c, colmax[j], j);
    warp_argmax(v, c);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      c = warp_i[lane];
      warp_argmax(v, c);
      if (lane == 0) {
        best_v = v;
        best_w = c;
      }
    }
    __syncthreads();
    if (best_v == -CUDART_INF_F) break;  // the same for every thread
    const int wc = best_w;
    const int hh = colrow[wc];
    if (tid == 0) {
      picks[2 * i] = hh;
      picks[2 * i + 1] = wc;
    }

    // Suppress the (2m+1)^2 window, clipped to the map.
    for (int k = tid; k < mw * mw; k += kThreads) {
      const int cc = wc - m + k / mw;
      const int rr = hh - m + k % mw;
      if (cc >= 0 && cc < w && rr >= 0 && rr < h)
        score_t[(size_t)cc * h + rr] = -CUDART_INF_F;
    }
    __syncthreads();

    // Re-reduce the touched columns, one warp each.
    for (int k = warp; k < mw; k += kWarps) {
      const int cc = wc - m + k;
      if (cc >= 0 && cc < w) {
        float cv;
        int cr;
        reduce_column(score_t + (size_t)cc * h, h, lane, cv, cr);
        if (lane == 0) {
          colmax[cc] = cv;
          colrow[cc] = cr;
        }
      }
    }
    __syncthreads();
    ++n;
  }

  for (int k = n + tid; k < num_picks; k += kThreads) {
    picks[2 * k] = -1;
    picks[2 * k + 1] = -1;
  }
  if (tid == 0) *count = n;
}

}  // namespace

// score_t: (w, h) float32 scratch, overwritten; picks: (num_picks, 2) int32
// rows [h, w]; count: one int32. Launches on ``stream``, allocates nothing,
// does not synchronise.
extern "C" int halo_greedy_picks(float* score_t, int h, int w, int num_picks,
                                 int mask_radius, int* picks, int* count,
                                 void* stream) {
  const size_t smem = (size_t)w * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_picks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_picks_kernel<<<1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      score_t, h, w, num_picks, mask_radius, picks, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* halo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
