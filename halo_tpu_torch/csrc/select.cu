// Kernel A: greedy region picks on a stack of score maps, one block a map.
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
// read of the 8 MB map (1024x2048 f32), ~2.5 us at 3.35 TB/s. But the
// picks form one serial chain: every pick needs the previous pick's
// suppression, so the time is the chain's length times the latency of one
// step, and a step has to stay inside one SM and touch as little memory as
// it can.
//
// Design. The wrapper hands over a scratch copy of the maps transposed to
// (n, W, H), so a column is contiguous; at 1024x2048 a map is 8 MB and
// stays in the 50 MB L2. Three levels of (max, first argmax) caches:
//  - segments: each column is cut into segments of S rows (S = 128 at
//    1024x2048: the smallest of 32, 64, ..., 512 whose cache fits in shared
//    memory), one entry a (column, segment): 128 KB at 1024x2048;
//  - columns: one entry a column, from its segments in row order (16 KB);
//  - groups: one entry per group of G columns (G = 64 at W = 2048: 32 * 2^k,
//    the fewest that make at most 32 groups, one a lane of warp 0).
// The segment caches of every map are first reduced by a grid-wide kernel
// (seg_init_kernel: one warp a segment over the whole card), then each map's
// block loads them and runs its chain. A pick is:
//  1. warp 0 takes the argmax over the group entries, reading the columns
//     of the groups the previous pick touched in place of their stale
//     entries (one warp reduction), publishes it and arrives at a barrier
//     without waiting there; the other warps wait for it;
//  2. warp 0 goes straight on with the picked column, the last warp
//     rewrites the stale groups' entries, and one warp each of the other
//     touched columns; a warp writes -inf over the window's rows of its
//     column and re-reduces only the segments whose cached argmax row lies
//     in the window (their values read into registers, S/32 a lane, the
//     window applied there: one L2 round trip, the only one of the pick).
//     A column whose cached argmax row lies outside the window keeps its
//     entry, since the suppression lowers no value outside those rows; any
//     other column is rebuilt from its segment entries in row order. A
//     block barrier ends the pick.
// So the picked column waits on no barrier and one global-memory round
// trip; segment heights and group widths are powers of two (shifts, no
// divisions) and a lane's rows are unrolled at compile time.
// Scores are compared as ints that order like the floats (-0 and +0 one
// key), so a warp combines (key, index) pairs with two redux.sync
// reductions: the largest key, then the smallest index that holds it. Every
// combination thus takes the larger value or, on equal values, the smaller
// index, so ties keep first occurrence; an all -inf column caches row 0 as
// jnp.argmax does. The -inf stores of a pick go out after its loads.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerLane = 16;  // S <= 512
constexpr int kMaxSegments = 32;     // a column's segments fit in one warp
constexpr int kMaxGroups = 32;       // the groups fit in one warp
constexpr unsigned kFull = 0xffffffffu;

// An int that orders like the float it comes from (no NaN): -0 and +0 map
// to one key, as they compare equal.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v == 0.f ? 0.f : v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
constexpr int kNegInfKey = static_cast<int>(0xff800000u ^ 0x7fffffffu);

// (k, i) <- (k2, i2) when k2 is greater, or equal with a smaller index.
__device__ __forceinline__ void take_better(int& k, int& i, int k2, int i2) {
  if (k2 > k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

// The same combination over a warp, in two warp reductions (redux.sync):
// the largest key, then the smallest index among the lanes that hold it.
// Every lane gets the result.
__device__ __forceinline__ void warp_argmax(int& k, int& i) {
  const int best = __reduce_max_sync(kFull, k);
  i = __reduce_min_sync(kFull, k == best ? i : INT_MAX);
  k = best;
}

// Segment (max key, first argmax row) of every (map, column, segment), one
// warp each; entry t = (map * w + column) * nseg + segment.
__global__ void __launch_bounds__(256)
seg_init_kernel(const float* __restrict__ score_t, long long tasks, int h,
                int seg_rows, int nseg, int* __restrict__ segkey,
                int* __restrict__ segrow) {
  const int lane = threadIdx.x & 31;
  const long long nw = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       t < tasks; t += nw) {
    const int s = static_cast<int>(t % nseg);
    const float* col = score_t + (t / nseg) * h;
    const int end = min(s * seg_rows + seg_rows, h);
    int k = kNegInfKey;
    int r = INT_MAX;
#pragma unroll 4
    for (int row = s * seg_rows + lane; row < end; row += 32)
      take_better(k, r, order_key(col[row]), row);
    warp_argmax(k, r);
    if (lane == 0) {
      segkey[t] = k;
      segrow[t] = r;
    }
  }
}

// (max key, first column) of columns [c0, c1), by one whole warp; every
// lane gets it.
__device__ __forceinline__ void reduce_columns(const int* colkey, int c0,
                                               int c1, int lane, int& k,
                                               int& c) {
  k = kNegInfKey;
  c = INT_MAX;
  for (int j = c0 + lane; j < c1; j += 32) take_better(k, c, colkey[j], j);
  warp_argmax(k, c);
}

// kRows: rows of a segment a lane holds (a segment is 32 * kRows rows).
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
greedy_picks_kernel(float* score_all, int h, int w, int num_picks, int m,
                    int nseg, int group_bits,
                    const int* __restrict__ segkey_g,
                    const int* __restrict__ segrow_g, int* picks_all,
                    int* count_all) {
  constexpr int kSegRows = 32 * kRows;
  extern __shared__ int cache[];
  int* colkey = cache;                 // w
  int* colrow = colkey + w;            // w
  int* segkey = colrow + w;            // w x nseg, [column][segment]
  int* segrow = segkey + w * nseg;     // w x nseg
  __shared__ int gkey[kMaxGroups];
  __shared__ int gcol[kMaxGroups];
  __shared__ int best_c, best_r;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int map = blockIdx.x;
  float* score_t = score_all + static_cast<size_t>(map) * w * h;
  int* picks = picks_all + static_cast<size_t>(map) * num_picks * 2;
  const int group = 1 << group_bits;
  const int ngroups = (w + group - 1) >> group_bits;

  const size_t off = static_cast<size_t>(map) * w * nseg;
  for (int i = tid; i < w * nseg; i += kThreads) {
    segkey[i] = segkey_g[off + i];
    segrow[i] = segrow_g[off + i];
  }
  __syncthreads();
  for (int c = tid; c < w; c += kThreads) {
    int k = kNegInfKey;
    int r = INT_MAX;
    for (int s = 0; s < nseg; ++s)
      take_better(k, r, segkey[c * nseg + s], segrow[c * nseg + s]);
    colkey[c] = k;
    colrow[c] = r;
  }
  __syncthreads();
  for (int g = warp; g < ngroups; g += kWarps) {
    int k, c;
    reduce_columns(colkey, g * group, min(g * group + group, w), lane, k, c);
    if (lane == 0) {
      gkey[g] = k;
      gcol[g] = c;
    }
  }
  __syncthreads();

  // Groups [t_lo, t_hi] hold the columns the previous pick touched: their
  // cached entries are stale until the last warp rewrites them, so the
  // argmax reads their columns instead.
  int t_lo = 0, t_hi = -1;
  int n = 0;
  for (int i = 0; i < num_picks; ++i) {
    int wc, hh;
    if (warp == 0) {
      int k = kNegInfKey;
      int c = INT_MAX;
      if (lane < ngroups && (lane < t_lo || lane > t_hi)) {
        k = gkey[lane];
        c = gcol[lane];
      }
      const int c1 = min((t_hi + 1) << group_bits, w);
      for (int j = (t_lo << group_bits) + lane; j < c1; j += 32)
        take_better(k, c, colkey[j], j);
      warp_argmax(k, c);
      wc = k == kNegInfKey ? -1 : c;
      hh = wc < 0 ? 0 : colrow[wc];
      if (lane == 0) {
        best_c = wc;
        best_r = hh;
      }
      __syncwarp();
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      wc = best_c;
      hh = best_r;
    }
    if (wc < 0) break;  // all -inf: the same for every thread
    const int r_lo = max(hh - m, 0);
    const int r_hi = min(hh + m, h - 1);

    // Warp 0 records the pick; the last warp rewrites the stale group
    // entries. A group the current pick touches too may read a mix of old
    // and new column keys; its entry is not read before this step runs
    // again for it.
    if (warp == 0 && lane == 0) {
      picks[2 * i] = hh;
      picks[2 * i + 1] = wc;
    }
    if (warp == kWarps - 1) {
      for (int g = t_lo; g <= t_hi; ++g) {
        int k, c;
        reduce_columns(colkey, g * group, min(g * group + group, w), lane, k,
                       c);
        if (lane == 0) {
          gkey[g] = k;
          gcol[g] = c;
        }
      }
    }

    // Suppress the window column by column, one warp each: warp 0 the
    // picked column (q = m), warps 1.. the others.
    for (int t = warp == 0 ? -1 : warp - 1; t < 2 * m;
         t = warp == 0 ? 2 * m : t + kWarps - 1) {
      const int q = t < 0 ? m : (t < m ? t : t + 1);
      const int cc = wc - m + q;
      if (cc < 0 || cc >= w) continue;
      const int e0 = cc * nseg;
      const int ck = colkey[cc];
      const int cr = colrow[cc];
      const bool col_hit = ck != kNegInfKey && cr >= r_lo && cr <= r_hi;
      // This lane's segment entry, for the column's rebuild.
      int sk = kNegInfKey;
      int sr = INT_MAX;
      if (col_hit && lane < nseg) {
        sk = segkey[e0 + lane];
        sr = segrow[e0 + lane];
      }
      float* col = score_t + static_cast<size_t>(cc) * h;
      const int s_hi = r_hi / kSegRows;
      for (int s = r_lo / kSegRows; s <= s_hi; ++s) {
        const int e = e0 + s;
        const int er = segrow[e];
        if (segkey[e] == kNegInfKey || er < r_lo || er > r_hi) continue;
        // The segment's rows into registers (a lane's rows are 32 apart),
        // all loads issued before any is used; the window's rows count as
        // -inf.
        const int row0 = s * kSegRows + lane;
        float vals[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = row0 + 32 * j;
          vals[j] = r < h ? col[r] : 0.f;
        }
        int k = kNegInfKey;
        int kr = INT_MAX;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = row0 + 32 * j;
          if (r < h)
            take_better(k, kr,
                        (r >= r_lo && r <= r_hi) ? kNegInfKey
                                                 : order_key(vals[j]),
                        r);
        }
        warp_argmax(k, kr);
        if (lane == s) {
          sk = k;
          sr = kr;
        }
        if (lane == 0) {
          segkey[e] = k;
          segrow[e] = kr;
        }
      }
      // The -inf stores come after the loads, so no load waits on them;
      // the next pick reads them after the block barrier.
      for (int r = r_lo + lane; r <= r_hi; r += 32) col[r] = -CUDART_INF_F;
      if (col_hit) {  // rebuild the column from its segments, in row order
        warp_argmax(sk, sr);
        if (lane == 0) {
          colkey[cc] = sk;
          colrow[cc] = sr;
        }
      }
    }
    __syncthreads();
    t_lo = max(wc - m, 0) >> group_bits;
    t_hi = min(wc + m, w - 1) >> group_bits;
    ++n;
  }

  for (int k = n + tid; k < num_picks; k += kThreads) {
    picks[2 * k] = -1;
    picks[2 * k + 1] = -1;
  }
  if (tid == 0) count_all[map] = n;
}

template <int kRows>
cudaError_t launch_picks(float* score_t, int n, int h, int w, int num_picks,
                         int m, int nseg, int group_bits, const int* segkey,
                         const int* segrow, int* picks, int* count,
                         size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_picks_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  greedy_picks_kernel<kRows><<<n, kThreads, smem, st>>>(
      score_t, h, w, num_picks, m, nseg, group_bits, segkey, segrow, picks,
      count);
  return cudaGetLastError();
}

}  // namespace

// score_t: (n, w, h) float32 scratch, overwritten; picks: (n, num_picks, 2)
// int32 rows [h, w]; count: (n,) int32; scratch: at least
// n * w * ceil(h / 32) * 8 bytes of device memory for the segment caches.
// Launches on ``stream`` (a grid-wide segment reduction, then one block a
// map), allocates nothing, does not synchronise.
extern "C" int halo_greedy_picks(float* score_t, int n, int h, int w,
                                 int num_picks, int mask_radius, int* picks,
                                 int* count, void* scratch, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_picks < 0 || mask_radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The smallest segment (32 rows times a power of two) whose cache fits
  // beside the column cache and the kernel's static shared memory.
  const size_t budget = static_cast<size_t>(max_smem) - 1024;
  int seg_rows = 0, nseg = 0;
  size_t smem = 0;
  for (int r = 1; r <= kMaxRowsPerLane && seg_rows == 0; r *= 2) {
    const int s = 32 * r;
    const int k = (h + s - 1) / s;
    const size_t bytes = static_cast<size_t>(w) * (k + 1) * 8;
    if (k <= kMaxSegments && bytes <= budget) {
      seg_rows = s;
      nseg = k;
      smem = bytes;
    }
  }
  if (seg_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  // Groups of 32 * 2^k columns, the fewest that make at most 32 groups.
  int group_bits = 5;
  while (((w - 1) >> group_bits) >= kMaxGroups) ++group_bits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  int* segkey = static_cast<int*>(scratch);
  int* segrow = segkey + static_cast<size_t>(n) * w * nseg;
  const long long tasks = static_cast<long long>(n) * w * nseg;
  const long long want = (tasks * 32 + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  seg_init_kernel<<<blocks, 256, 0, st>>>(score_t, tasks, h, seg_rows, nseg,
                                          segkey, segrow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // One instantiation for each segment height: 32, 64, ..., 512 rows.
  decltype(&launch_picks<1>) const launch[] = {
      launch_picks<1>, launch_picks<2>, launch_picks<4>, launch_picks<8>,
      launch_picks<16>};
  err = launch[__builtin_ctz(seg_rows / 32)](
      score_t, n, h, w, num_picks, mask_radius, nseg, group_bits, segkey,
      segrow, picks, count, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* halo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
