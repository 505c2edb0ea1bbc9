// Kernel B redesigned as the round's score stage: the native-resolution
// region score of one image, entropy x radius, in two launches.
//
// Replaces the TPU kernel radius_map (halo_tpu/active/pallas_radius.py:100,
// body _radius_kernel_3d at :79) on the round's path, together with the work
// that fed it there and in the port before: the align-corners upsample of
// the logits and of the ball embedding to the native size
// (halo_tpu/active/scoring.py:376, fused_upsample_region_score), the
// one-pass entropy (:141), the (2r+1)^2 zero-padded window sum (:78) and the
// min-max normalisation (:120). For an image with logits (h, w, K) and an
// embedding (h2, w2, E) at the head's resolutions and a native (H, W):
//
//   up(X)[y, x] = wl_c[x] * R[y, lo_c[x]] + wh_c[x] * R[y, hi_c[x]],
//   R[y, j]     = wl_r[y] * X[lo_r[y], j] + wh_r[y] * X[hi_r[y], j]
//
// (rows first, then columns, each a sum of two products rounded apart:
// the two nonzero entries of ops/resize.py:_interp_matrix's row, from the
// tables ops/resize.py:interp_table builds on the host), cast to the score
// dtype; entropy = (log s - t / s) / log 19 over the logits clamped to +-60
// (s = sum e^v, t = sum v e^v); radius = (2/sqrt c) artanh(clamp(sqrt c
// |up(E)|, 1 - 1e-7)); uncertainty = the window sum of the entropy in
// box_filter's order (the rows of a column first, then the columns, taps
// in ascending offset, zeros outside the map); then each map normalised as
// (x - lo) / (hi - lo) with an IEEE division, and score = impurity x
// uncertainty.
//
// S1 (score_tile_kernel) owns a tile of 16 x 64 native pixels. For each
// source (the logits with r halo rows and columns around the tile, then the
// embedding) it stages the raw input band the tile reads (input rows lo..hi
// of its native rows, the input columns of its native columns, a chunk of
// channels) from device memory into shared memory with cp.async, double
// buffered: chunk n + 1 is in flight while chunk n is contracted. From the
// staged band it forms the row contraction once per (tile row, input column,
// channel) in shared memory, then for every pixel the column contraction,
// the cast and the entropy (or the sum of squares), with the pixel's
// channels in registers; the haloed tile's entropies stay in shared memory
// for the window sums. It writes the windowed uncertainty and the radius and
// the tile's four extremes. S2 (normalize_kernel) reduces the extremes of
// every tile and writes score, impurity and uncertainty in place.
//
// What bounds it on an H100: bytes. A 1024x2048 image from 640x1280x19 f32
// logits and a 160x320x64 f32 embedding reads 62.3 + 13.1 MB and writes
// three 8.4 MB maps: 100.6 MB, 0.030 ms at 3.35 TB/s; the two maps S1
// writes and S2 reads back add 33.6 MB (134 MB, 0.040 ms). Its ~1.5 G
// floating-point operations take ~0.02 ms at the float32 rate, but as
// instructions (each of the 2.4 M haloed pixels' 19 channels: two
// shared loads, the interpolation, the cast, the clamp, expf and the sums;
// each of the 2.1 M pixels' 64 embedding channels: two shared loads, the
// interpolation, the cast and a square) they are ~100 M warp instructions,
// ~0.1 ms at four a cycle on 132 multiprocessors. The design keeps every
// native-resolution intermediate (the 537 MB upsampled embedding, the
// 159 MB upsampled logits, the per-pixel entropy) out of device memory and
// reads each input element once a tile whose band holds it (a tile of the
// logits reads ~13 input rows for its 18 haloed rows, of the embedding ~4
// for its 16), asynchronously, so that the instruction slots go to
// the arithmetic; the contractions give a thread the pixels of one column
// (its taps in registers) as independent chains over the channels. 2048
// tiles of 256 threads at 1024x2048, three a streaming multiprocessor
// (~60 KB of shared memory each). Measured on an H100 (tools/score_probe.py
// rebuilds S1 without its loads, its expf, its logits or its embedding):
// ~0.25 ms, of which the reads are ~13%: the contractions' instructions, at
// 1-1.7 warp instructions a cycle a multiprocessor, set its time.
//
// No fast-math: expf, logf, atanhf, sqrtf and the divisions are the
// accurate ones, and the products and sums of the interpolation carry
// explicit rounding (__fmul_rn, __fadd_rn) so that they are not contracted
// into an FMA: with the same inputs the upsampled values equal the plain
// version's (cuda_score.region_maps_plain) bit for bit, and the maps differ
// from it by the order of the channel sums only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16;        // native rows a tile
constexpr int kTW = 64;        // native columns a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;       // the largest window half-width taken
constexpr int kRowsL = kTH + 2 * kMaxR;  // the most haloed tile rows
constexpr int kPixI = kTH * kTW / kThreads;  // tile pixels a thread
// Haloed-tile rows a thread takes in the logits' contraction, at most: a
// thread owns one column of the haloed tile (kTW + 2r wide) and every G-th
// row, G = kThreads / (kTW + 2r): 6 for r <= 1, 11 for r <= kMaxR.
constexpr int kRowsSmall = 6;
constexpr int kRowsLarge =
    (kRowsL + kThreads / (kTW + 2 * kMaxR) - 1) / (kThreads / (kTW + 2 * kMaxR));
constexpr float kClamp = 60.0f;

// An (h, w, C) map with any element strides.
struct Src {
  const void* ptr;
  long long sr, sc, sk;
  int h, w, ch;
};

// One axis' interpolation table, 4 x n 32-bit words: lo, hi (int32), then
// the weights wl, wh (float32 bits).
struct Table {
  const int* t;
  int n;
  __device__ __forceinline__ int lo(int i) const { return __ldg(t + i); }
  __device__ __forceinline__ int hi(int i) const { return __ldg(t + n + i); }
  __device__ __forceinline__ float wl(int i) const {
    return __int_as_float(__ldg(t + 2 * n + i));
  }
  __device__ __forceinline__ float wh(int i) const {
    return __int_as_float(__ldg(t + 3 * n + i));
  }
};

struct Params {
  Src lg, em;
  Table lrow, lcol, erow, ecol;
  float* unc;
  float* imp;
  float* ext;
  int H, W, r, tiles_w;
  int score_bf16;
  int ck_l, ck_e;    // channels a chunk
  int nbp_l, nbp_e;  // band width in shared memory (odd)
  int x_words;       // floats of one staging buffer
  int r_words;       // floats of the row contraction
  float sqrt_c, two_over_sqrt_c, inv_log19;
};

// A tile's band of one source: tile rows from native row yt0 on, of which
// [ya, yb) lie in the map; input rows [ilo, ilo + nr) and input columns
// [clo, clo + nb) hold every tap of those rows and of native columns
// xa..xb.
struct Band {
  int yt0, ya, yb, ilo, nr, clo, nb;
};

__device__ __forceinline__ Band band_of(const Table& rows, const Table& cols,
                                        int H, int yt0, int nrows, int xa,
                                        int xb) {
  Band b;
  b.yt0 = yt0;
  b.ya = max(yt0, 0);
  b.yb = min(yt0 + nrows, H);
  b.ilo = rows.lo(b.ya);
  b.nr = rows.hi(b.yb - 1) - b.ilo + 1;
  b.clo = cols.lo(xa);
  b.nb = cols.hi(xb) - b.clo + 1;
  return b;
}

// A tile row's two input rows, as word offsets into the staged band, and
// their weights.
struct __align__(16) RowTap {
  int lo, hi;
  float wl, wh;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A float32 element is copied asynchronously; a bf16 one is widened on the
// way (a synchronous load: cp.async moves 4-byte words at the least).
__device__ __forceinline__ void stage_one(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void stage_one(float* dst,
                                          const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// q = e / d for 0 <= e < 2^24 and 0 < d, by a float estimate and one fix.
__device__ __forceinline__ int div_small(int e, int d, float inv_d) {
  int q = __float2int_rz(__int2float_rn(e) * inv_d);
  const int rem = e - q * d;
  if (rem < 0) --q;
  else if (rem >= d) ++q;
  return q;
}

// X[(i * ck_max + k) * nbp + j] = x[ilo + i, clo + j, c0 + k] for the band's
// rows i < nr, columns j < nb and channels k < ck. A thread takes one (j, k)
// down all the rows; consecutive threads take consecutive channels when the
// channel stride is 1 (the head's channel-last maps), else consecutive
// columns, so that a warp's copies read neighbouring words.
template <typename T>
__device__ __forceinline__ void stage(const Src& s, const Band& b, int c0,
                                      int ck, int ck_max, int nbp, float* X) {
  const T* x = static_cast<const T*>(s.ptr) + (long long)b.ilo * s.sr +
               (long long)b.clo * s.sc + (long long)c0 * s.sk;
  const bool chan_inner = s.sk == 1;
  const int inner = chan_inner ? ck : b.nb;
  const float inv_inner = 1.0f / inner;
  const int plane = ck_max * nbp;
  for (int f = threadIdx.x; f < ck * b.nb; f += kThreads) {
    const int a = div_small(f, inner, inv_inner);
    const int c = f - a * inner;
    const int j = chan_inner ? a : c;
    const int k = chan_inner ? c : a;
    const T* src = x + (long long)j * s.sc + (long long)k * s.sk;
    float* dst = X + k * nbp + j;
    for (int i = 0; i < b.nr; ++i)
      stage_one(dst + i * plane, src + (long long)i * s.sr);
  }
}

// R[(rr * ck_max + k) * nbp + j] = wl * X[lo, k, j] + wh * X[hi, k, j] for
// the tile rows rr in [rr_a, rr_b) (those in the map), from the staged band
// X and the rows' taps; consecutive threads take consecutive columns.
__device__ __forceinline__ void row_contract(const float* X,
                                             const RowTap* taps, int rr_a,
                                             int rr_b, int nb, int ck,
                                             int plane, int nbp, float* R) {
  const float inv_nb = 1.0f / nb;
  for (int f = threadIdx.x; f < ck * nb; f += kThreads) {
    const int k = div_small(f, nb, inv_nb);
    const int j = f - k * nb;
    const float* xc = X + k * nbp + j;
    float* out = R + k * nbp + j;
    for (int rr = rr_a; rr < rr_b; ++rr) {
      const RowTap t = taps[rr];
      out[rr * plane] =
          __fadd_rn(__fmul_rn(t.wl, xc[t.lo]), __fmul_rn(t.wh, xc[t.hi]));
    }
  }
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <bool kBf16>
__device__ __forceinline__ float to_score(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// T: the logits' dtype; kBf16: the score dtype is bf16; kRows: the most
// haloed-tile rows a thread takes (kRowsSmall or kRowsLarge).
template <typename T, bool kBf16, int kRows>
__global__ void __launch_bounds__(kThreads, 3)
score_tile_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ RowTap taps_l[kRowsL], taps_e[kTH];
  const int r = p.r;
  const int ty = blockIdx.x / p.tiles_w;
  const int tx = blockIdx.x - ty * p.tiles_w;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int we = kTW + 2 * r;            // haloed tile width
  const int rows_l = kTH + 2 * r;        // haloed tile rows
  float* R = smem + 2 * p.x_words;
  float* E = R + p.r_words;
  const float inv_we = 1.0f / we;
  const Band bl = band_of(p.lrow, p.lcol, p.H, y0 - r, rows_l,
                          max(x0 - r, 0), min(x0 + kTW + r, p.W) - 1);
  const Band be = band_of(p.erow, p.ecol, p.H, y0, kTH, x0,
                          min(x0 + kTW, p.W) - 1);
  const int plane_l = p.ck_l * p.nbp_l, plane_e = p.ck_e * p.nbp_e;
  const int n_l = (p.lg.ch + p.ck_l - 1) / p.ck_l;
  const int n = n_l + (p.em.ch + p.ck_e - 1) / p.ck_e;

  // chunk s: the logits' channels s * ck_l.. for s < n_l, then the
  // embedding's; staged into buffer s % 2 as one cp.async group
  auto stage_chunk = [&](int s) {
    float* X = smem + (s & 1) * p.x_words;
    if (s < n_l) {
      const int c0 = s * p.ck_l;
      stage<T>(p.lg, bl, c0, min(p.ck_l, p.lg.ch - c0), p.ck_l, p.nbp_l, X);
    } else {
      const int c0 = (s - n_l) * p.ck_e;
      stage<float>(p.em, be, c0, min(p.ck_e, p.em.ch - c0), p.ck_e, p.nbp_e,
                   X);
    }
    cp_async_commit();
  };
  stage_chunk(0);
  {
    const int t = threadIdx.x;
    if (t < rows_l) {
      const int y = bl.yt0 + t;
      if (y >= bl.ya && y < bl.yb)
        taps_l[t] = RowTap{(p.lrow.lo(y) - bl.ilo) * plane_l,
                           (p.lrow.hi(y) - bl.ilo) * plane_l, p.lrow.wl(y),
                           p.lrow.wh(y)};
    } else if (t >= kRowsL && t < kRowsL + kTH) {
      const int y = be.yt0 + t - kRowsL;
      if (y < be.yb)
        taps_e[t - kRowsL] = RowTap{(p.erow.lo(y) - be.ilo) * plane_e,
                                    (p.erow.hi(y) - be.ilo) * plane_e,
                                    p.erow.wl(y), p.erow.wh(y)};
    }
  }

  // The logits' contraction: a thread owns column xl of the haloed tile
  // and its rows gl, gl + G, ...; its taps are the column's, its chains
  // (one a row) independent. The embedding's: column xe of the tile, rows
  // ge, ge + 4, ... (the pixels the window sums below take).
  const int G = kThreads / we;
  const int gl = div_small(threadIdx.x, we, inv_we);
  const int xl = threadIdx.x - gl * we;
  const int rows_t = gl < G ? (rows_l - gl + G - 1) / G : 0;  // <= kRows
  const int xg = x0 - r + xl;
  const bool col_l = gl < G && xg >= 0 && xg < p.W;
  const int jl_l = col_l ? p.lcol.lo(xg) - bl.clo : 0;
  const int dj_l = col_l ? p.lcol.hi(xg) - bl.clo - jl_l : 0;
  const float wl_l = col_l ? p.lcol.wl(xg) : 0.f;
  const float wh_l = col_l ? p.lcol.wh(xg) : 0.f;
  const int xe = threadIdx.x % kTW, ge = threadIdx.x / kTW;
  const bool col_e = x0 + xe < p.W;
  const int jl_e = col_e ? p.ecol.lo(x0 + xe) - be.clo : 0;
  const int dj_e = col_e ? p.ecol.hi(x0 + xe) - be.clo - jl_e : 0;
  const float wl_e = col_e ? p.ecol.wl(x0 + xe) : 0.f;
  const float wh_e = col_e ? p.ecol.wh(x0 + xe) : 0.f;

  float s_[kRows], t_[kRows], ss[kPixI];
#pragma unroll
  for (int i = 0; i < kRows; ++i) s_[i] = t_[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kPixI; ++i) ss[i] = 0.f;
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) {
      stage_chunk(s + 1);  // into the buffer chunk s - 1 was contracted from
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk s staged; R's last reader done
    const float* X = smem + (s & 1) * p.x_words;
    if (s < n_l) {
      // --- the logits: entropy of every pixel of the haloed tile ---------
      const int ck = min(p.ck_l, p.lg.ch - s * p.ck_l);
      row_contract(X, taps_l, bl.ya - bl.yt0, bl.yb - bl.yt0, bl.nb, ck,
                   plane_l, p.nbp_l, R);
      __syncthreads();
      if (col_l) {
        // rows outside the map read R rows never written: their sums are
        // dropped below
        const float* col = R + gl * plane_l + jl_l;
        for (int k = 0; k < ck; ++k) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (i < rows_t) {
              const float* a = col + i * G * plane_l + k * p.nbp_l;
              float v = __fadd_rn(__fmul_rn(wl_l, a[0]),
                                  __fmul_rn(wh_l, a[dj_l]));
              v = to_score<kBf16>(v);
              v = v < -kClamp ? -kClamp
                              : (v > kClamp ? kClamp : v);  // keeps NaN
              const float ev = expf(v);
              s_[i] = __fadd_rn(s_[i], ev);
              t_[i] = __fadd_rn(t_[i], __fmul_rn(v, ev));
            }
          }
        }
      }
      if (s == n_l - 1) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i < rows_t) {
            const int yy = gl + i * G;
            const int y = y0 - r + yy;
            const bool in = col_l && y >= 0 && y < p.H;
            E[yy * we + xl] =
                in ? __fmul_rn(__fsub_rn(logf(s_[i]), __fdiv_rn(t_[i], s_[i])),
                               p.inv_log19)
                   : 0.f;
          }
        }
      }
    } else {
      // --- the embedding: sum of squares of every pixel of the tile ------
      const int ck = min(p.ck_e, p.em.ch - (s - n_l) * p.ck_e);
      row_contract(X, taps_e, 0, be.yb - be.yt0, be.nb, ck, plane_e,
                   p.nbp_e, R);
      __syncthreads();
      if (col_e) {
        const float* col = R + ge * plane_e + jl_e;
        for (int k = 0; k < ck; ++k) {
#pragma unroll
          for (int i = 0; i < kPixI; ++i) {
            const float* a = col + i * (kThreads / kTW) * plane_e +
                             k * p.nbp_e;
            float v = __fadd_rn(__fmul_rn(wl_e, a[0]),
                                __fmul_rn(wh_e, a[dj_e]));
            v = to_score<kBf16>(v);
            ss[i] = fmaf(v, v, ss[i]);
          }
        }
      }
    }
  }
  // E was written before the embedding's chunks, whose barriers order it
  // before the window sums read it.

  // --- window sums, radius, the tile's extremes --------------------------
  const float kHi = static_cast<float>(1.0 - 1e-7);
  float lo_u = INFINITY, hi_u = -INFINITY, lo_i = INFINITY, hi_i = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPixI; ++i) {
    const int yy = ge + i * (kThreads / kTW), xx = xe;  // ss[i]'s pixel
    const int y = y0 + yy, x = x0 + xx;
    if (y >= p.H || x >= p.W) continue;
    float acc = 0.f;
    for (int dx = 0; dx <= 2 * r; ++dx) {
      const float* col = E + yy * we + xx + dx;
      float v = col[0];
      for (int dy = 1; dy <= 2 * r; ++dy) v = __fadd_rn(v, col[dy * we]);
      acc = dx == 0 ? v : __fadd_rn(acc, v);
    }
    float sq = ss[i];
    sq = sq < 1e-30f ? 1e-30f : sq;  // keeps NaN, as torch.clamp does
    float tn = __fmul_rn(p.sqrt_c, sqrtf(sq));
    tn = tn < -kHi ? -kHi : (tn > kHi ? kHi : tn);
    const float rad = __fmul_rn(p.two_over_sqrt_c, atanhf(tn));
    const long long o = (long long)y * p.W + x;
    p.unc[o] = acc;
    p.imp[o] = rad;
    lo_u = nan_min(lo_u, acc);
    hi_u = nan_max(hi_u, acc);
    lo_i = nan_min(lo_i, rad);
    hi_i = nan_max(hi_i, rad);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo_u = nan_min(lo_u, __shfl_xor_sync(0xffffffffu, lo_u, off));
    hi_u = nan_max(hi_u, __shfl_xor_sync(0xffffffffu, hi_u, off));
    lo_i = nan_min(lo_i, __shfl_xor_sync(0xffffffffu, lo_i, off));
    hi_i = nan_max(hi_i, __shfl_xor_sync(0xffffffffu, hi_i, off));
  }
  __shared__ float red[4][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = lo_u;
    red[1][warp] = hi_u;
    red[2][warp] = lo_i;
    red[3][warp] = hi_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      red[0][0] = nan_min(red[0][0], red[0][w]);
      red[1][0] = nan_max(red[1][0], red[1][w]);
      red[2][0] = nan_min(red[2][0], red[2][w]);
      red[3][0] = nan_max(red[3][0], red[3][w]);
    }
    float4 out = make_float4(red[0][0], red[1][0], red[2][0], red[3][0]);
    reinterpret_cast<float4*>(p.ext)[blockIdx.x] = out;
  }
}

// S2: the extremes of every tile, then, in place over the n pixels,
// unc = (unc - lo_u) / (hi_u - lo_u), imp likewise (when normalize), and
// score = imp * unc.
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const float4* __restrict__ ext, int tiles, float* unc,
                 float* imp, float* score, long long n, int normalize) {
  __shared__ float red[4][kWarps];
  __shared__ float fin[4];
  if (normalize) {
    float lo_u = INFINITY, hi_u = -INFINITY, lo_i = INFINITY,
          hi_i = -INFINITY;
    for (int b = threadIdx.x; b < tiles; b += kThreads) {
      const float4 e = ext[b];
      lo_u = nan_min(lo_u, e.x);
      hi_u = nan_max(hi_u, e.y);
      lo_i = nan_min(lo_i, e.z);
      hi_i = nan_max(hi_i, e.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo_u = nan_min(lo_u, __shfl_xor_sync(0xffffffffu, lo_u, off));
      hi_u = nan_max(hi_u, __shfl_xor_sync(0xffffffffu, hi_u, off));
      lo_i = nan_min(lo_i, __shfl_xor_sync(0xffffffffu, lo_i, off));
      hi_i = nan_max(hi_i, __shfl_xor_sync(0xffffffffu, hi_i, off));
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      red[0][warp] = lo_u;
      red[1][warp] = hi_u;
      red[2][warp] = lo_i;
      red[3][warp] = hi_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        red[0][0] = nan_min(red[0][0], red[0][w]);
        red[1][0] = nan_max(red[1][0], red[1][w]);
        red[2][0] = nan_min(red[2][0], red[2][w]);
        red[3][0] = nan_max(red[3][0], red[3][w]);
      }
      fin[0] = red[0][0];
      fin[1] = __fsub_rn(red[1][0], red[0][0]);
      fin[2] = red[2][0];
      fin[3] = __fsub_rn(red[3][0], red[2][0]);
    }
    __syncthreads();
  }
  const float lo_u = normalize ? fin[0] : 0.f, span_u = normalize ? fin[1] : 1.f;
  const float lo_i = normalize ? fin[2] : 0.f, span_i = normalize ? fin[3] : 1.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float u = unc[i], m = imp[i];
    if (normalize) {
      u = __fdiv_rn(__fsub_rn(u, lo_u), span_u);
      m = __fdiv_rn(__fsub_rn(m, lo_i), span_i);
      unc[i] = u;
      imp[i] = m;
    }
    score[i] = __fmul_rn(m, u);
  }
}

template <typename T, bool kBf16, int kRows>
int launch_s1(const Params& p, int tiles, int smem_bytes, void* stream) {
  static int granted = 48 * 1024;
  if (smem_bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        score_tile_kernel<T, kBf16, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem_bytes;
  }
  score_tile_kernel<T, kBf16, kRows><<<tiles, kThreads, smem_bytes,
                                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16>
int launch_s1_rows(const Params& p, int tiles, int smem_bytes, void* stream) {
  return p.r <= 1 ? launch_s1<T, kBf16, kRowsSmall>(p, tiles, smem_bytes, stream)
                  : launch_s1<T, kBf16, kRowsLarge>(p, tiles, smem_bytes, stream);
}

template <typename T>
int launch_s1_score(const Params& p, int tiles, int smem_bytes, void* stream) {
  return p.score_bf16 ? launch_s1_rows<T, true>(p, tiles, smem_bytes, stream)
                      : launch_s1_rows<T, false>(p, tiles, smem_bytes, stream);
}

}  // namespace

// S1. geom (int64): logits bf16?, its strides (row, column, channel), h, w,
// K; the embedding's strides, h2, w2, E; H, W, r, score bf16?, channels a
// chunk (logits, embedding), shared-memory band widths (logits,
// embedding), floats of a staging buffer and of the row contraction,
// dynamic shared-memory bytes (cuda_score.plan: two staging buffers, the
// row contraction, the haloed tile's entropies). fparams: sqrt c, 2 / sqrt c,
// 1 / log 19. The tables: 4 x n int32 words each (ops/resize.py).
extern "C" int halo_region_score_s1(
    const void* logits, const float* embed, const int* lrow, const int* lcol,
    const int* erow, const int* ecol, float* unc, float* imp, float* ext,
    const long long* geom, const float* fparams, void* stream) {
  Params p;
  p.lg = Src{logits, geom[1], geom[2], geom[3], (int)geom[4], (int)geom[5],
             (int)geom[6]};
  p.em = Src{embed, geom[7], geom[8], geom[9], (int)geom[10], (int)geom[11],
             (int)geom[12]};
  p.H = (int)geom[13];
  p.W = (int)geom[14];
  p.r = (int)geom[15];
  p.score_bf16 = (int)geom[16];
  p.ck_l = (int)geom[17];
  p.ck_e = (int)geom[18];
  p.nbp_l = (int)geom[19];
  p.nbp_e = (int)geom[20];
  p.x_words = (int)geom[21];
  p.r_words = (int)geom[22];
  const int smem_bytes = (int)geom[23];
  p.lrow = Table{lrow, p.H};
  p.lcol = Table{lcol, p.W};
  p.erow = Table{erow, p.H};
  p.ecol = Table{ecol, p.W};
  p.unc = unc;
  p.imp = imp;
  p.ext = ext;
  p.sqrt_c = fparams[0];
  p.two_over_sqrt_c = fparams[1];
  p.inv_log19 = fparams[2];
  if (p.H <= 0 || p.W <= 0 || p.r < 0 || p.r > kMaxR || p.lg.ch <= 0 ||
      p.em.ch <= 0 || p.ck_l <= 0 || p.ck_e <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (p.H + kTH - 1) / kTH;
  p.tiles_w = (p.W + kTW - 1) / kTW;
  const int tiles = tiles_h * p.tiles_w;
  return geom[0]
             ? launch_s1_score<__nv_bfloat16>(p, tiles, smem_bytes, stream)
             : launch_s1_score<float>(p, tiles, smem_bytes, stream);
}

// S2 over the n = H * W pixels of the maps S1 wrote; tiles = S1's tiles.
extern "C" int halo_region_score_s2(const float* ext, int tiles, float* unc,
                                    float* imp, float* score, long long n,
                                    int normalize, int grid, void* stream) {
  if (n <= 0 || tiles <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  normalize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(ext), tiles, unc, imp, score, n,
      normalize);
  return static_cast<int>(cudaGetLastError());
}
