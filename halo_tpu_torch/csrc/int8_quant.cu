// Kernel Q: the activation quantise of the int8 (W8A8) path, with the
// producer work that feeds it, in one pass.
//
// Replaces no Pallas kernel. The JAX package quantises an activation with
// elementwise jnp ops that XLA fuses into the producer's epilogue
// (halo_tpu/ops/quant.py:68, quantize_act), together with the frozen
// BatchNorm's per-channel affine (halo_tpu/models/layers.py:115-124), the
// ReLU and the ASPP concatenation (halo_tpu/models/classifier.py:168). In
// eager PyTorch each of those is a pass over the map of its own, about ten
// launches a site. This kernel does them all in one launch: for float32 or
// bfloat16 sources x_0 .. x_{n-1} (n <= 5), each seen as a logical (B, C_i,
// H, W) tensor with any element strides (a stride of 0 in H and W reads a
// (B, C_i, 1, 1) map broadcast over the pixels) and concatenated along the
// channels, optional per-channel scale and shift vectors in the sources'
// dtype T, an optional ReLU, and the layer's calibrated absmax read from
// device memory (no host sync):
//   y  = T(T(x * scale) + shift)         (two roundings, as the eager ops)
//   y  = y < 0 ? 0 : y                   (torch.relu: a NaN stays NaN)
//   sx = max(amax, eps) * inv127         (float32: XLA's product)
//   q[b, h, w, c] = int8(clamp(rint(float(y) / sx), -127, 127))
// with IEEE products, sums and division rounded to nearest (no FMA
// contraction), round half to even, the clamp on the integer (so +-inf
// saturates, and a NaN converts to 0 as torch's cast does), written
// as int8 (B, H, W, Cp), channels zero-padded to Cp (a multiple of 16):
// exactly the operand kernel I's tensor map reads.
// ops/quant.py:quantize_fused_plain computes the same bits.
//
// What bounds it on an H100: bytes. It reads 2 or 4 bytes and writes one an
// element; the R101 layer3 input (2, 256, 80, 160) bf16 is 6.6 MB in and
// 3.3 MB out, ~3 us at 3.35 TB/s. So its arithmetic must stay under the
// bytes' time, and a launch's fixed costs (the launch, the first loads'
// latency, a partial last wave) small. The design, with one of two kernels
// a call:
//  - rows (every source's channels contiguous, a multiple of 16 and 16-byte
//    aligned: the channels-last maps and dense inputs the models make, the
//    ASPP branches): a unit is 16 channels of one pixel, one 16-byte int8
//    store. One wave of resident blocks (from the SM count) strides through
//    the units; a thread takes 2 (bf16) or 1 (f32) units a trip and issues
//    all of their 16-byte loads, 4 of them, before its first store;
//    neighbouring threads take neighbouring units. A single dense source
//    with C = Cp is a flat map (unit u at element 16u in and out); otherwise
//    a unit's pixel, channel and source come from divisions by a multiply
//    and a shift prepared on the host, never an integer division. The
//    bf16 prologue runs on bf16 pairs (one product, one sum, one max for
//    two values), and the quantise takes no division: a product with the
//    reciprocal of sx and two corrections by fused multiply-adds give the
//    IEEE quotient (the division's subroutine, a value at a time, took
//    twice as long at the layer3 site on the card).
//  - tiles (any other strides: NCHW; not the models' layouts): a block
//    quantises 64 pixels x 64 channels, reading along the pixels, each
//    thread packing four channels of its pixel into a 32-bit word of a
//    shared-memory tile (odd word pitch: conflict-free), which the block
//    writes out channels-fastest, 64 bytes a pixel, coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSources = 5;
constexpr int kUnit = 16;              // channels a unit: one int8 store
constexpr int kTile = 64;              // pixels and channels a tile block
constexpr int kThreads = 256;
constexpr int kPitch = kTile / 4 + 1;  // words a pixel row of the tile
constexpr int kMaxDevices = 64;
constexpr int kRowsBlocks = 4;         // resident rows blocks an SM, at least

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (d >= 1).
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_fastdiv(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned log2 = 0;
    while ((1ull << log2) < d) ++log2;  // ceil(log2(d))
    const unsigned p = 31 + log2;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ unsigned fast_div(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

struct Source {
  const char* ptr;
  long long sB, sC, sH, sW;  // element strides
  int c0, C;                 // its channels [c0, c0 + C) of the whole
};

struct Plan {
  Source src[kMaxSources];
  int n_src;
  int C, Cp, B, H, W;
  unsigned units;      // rows: B * H * W * Cp / 16
  FastDiv groups;      // Cp / 16: units a pixel
  FastDiv hw, w;
  const float* amax;
  const char* scale;   // C values of T, or null: no affine
  const char* shift;
  int relu;
  int8_t* q;
  float eps, inv127;
};

__device__ __forceinline__ float act_scale(const float* amax, float eps,
                                           float inv127) {
  return __fmul_rn(fmaxf(*amax, eps), inv127);
}

// v rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The prologue on one value: T(T(v * s) + t), then the ReLU.
template <typename T>
__device__ __forceinline__ float prologue(float v, float s, float t,
                                          bool affine, bool relu) {
  if (affine) {
    v = round_to<T>(__fmul_rn(v, s));
    v = round_to<T>(__fadd_rn(v, t));
  }
  if (relu) v = v < 0.f ? 0.f : v;
  return v;
}

__device__ __forceinline__ int clamp127(int i) {
  return min(max(i, -127), 127);
}

// int8(clamp(rint(v / sx), -127, 127)) with v / sx the IEEE quotient
// rounded to nearest (as torch's and XLA's division), round half to even,
// the clamp on the integer (+-inf saturate; a NaN converts to 0, as
// torch's cast gives it). The quotient without a division: q0 = v * r, r
// = 1/sx rounded to nearest, then two corrections q + (v - sx q) r, each
// residual exact by a fused multiply-add; the second starts from a
// faithful quotient and a correctly rounded reciprocal, so it is the
// correctly rounded quotient (Markstein). Past 1e30 (and for +-inf and
// NaN, where the residuals are not finite) q0 itself: it clamps alike.
__device__ __forceinline__ int quantize(float v, float r, float sx) {
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-sx, q0, v), r, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-sx, q1, v), r, q1);
  const float d = fabsf(q0) < 1e30f ? q2 : q0;
  return clamp127(__float2int_rn(d));
}

// The low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int kLoads>
__device__ __forceinline__ void load_unit(const char* p, uint4 (&raw)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
    raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <int kLoads>
__device__ __forceinline__ uint32_t word_of(const uint4 (&raw)[kLoads], int i) {
  const uint4& w = raw[i / 4];
  return i % 4 == 0 ? w.x : i % 4 == 1 ? w.y : i % 4 == 2 ? w.z : w.w;
}

// bf16 pairs: the product and the sum each rounded once to nearest, with
// the rounding written out so that they are never contracted into one
// fused multiply-add (the eager ops round twice); a max that keeps a NaN.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// Values 2w and 2w + 1 of a unit, the prologue applied, as floats: a bf16
// unit is 8 words of pairs (one product, sum and max a pair), a float32
// one 16 words.
__device__ __forceinline__ float2 unit_pair(const uint4 (&raw)[2],
                                            const uint4 (&sc)[2],
                                            const uint4 (&sh)[2], int w,
                                            bool affine, bool relu) {
  uint32_t v = word_of(raw, w);
  if (affine) v = add_bf16x2(mul_bf16x2(v, word_of(sc, w)), word_of(sh, w));
  if (relu) v = relu_bf16x2(v);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ float2 unit_pair(const uint4 (&raw)[4],
                                            const uint4 (&sc)[4],
                                            const uint4 (&sh)[4], int w,
                                            bool affine, bool relu) {
  float v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    v[k] = __uint_as_float(word_of(raw, 2 * w + k));
    if (affine)
      v[k] = __fadd_rn(__fmul_rn(v[k], __uint_as_float(word_of(sc, 2 * w + k))),
                       __uint_as_float(word_of(sh, 2 * w + k)));
    if (relu) v[k] = v[k] < 0.f ? 0.f : v[k];
  }
  return make_float2(v[0], v[1]);
}

// One unit's 16 int8 values from its 16 values (``raw``: sizeof(T) 16-byte
// words), the prologue first.
template <int kLoads>
__device__ __forceinline__ uint4 quantize_unit(
    const uint4 (&raw)[kLoads], const uint4 (&sc)[kLoads],
    const uint4 (&sh)[kLoads], bool affine, bool relu, float r, float sx) {
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int q[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 v = unit_pair(raw, sc, sh, 2 * i + k, affine, relu);
      q[2 * k] = quantize(v.x, r, sx);
      q[2 * k + 1] = quantize(v.y, r, sx);
    }
    out[i] = pack4(q[0], q[1], q[2], q[3]);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Rows: unit u is channels 16g .. 16g + 15 of pixel p, u = p * Cp/16 + g,
// written at q + 16u. kFlat: one source, dense pixels, C = Cp (unit u
// reads elements 16u ..).
template <typename T, bool kFlat>
__global__ void __launch_bounds__(kThreads, kRowsBlocks)
quantize_rows_kernel(const Plan plan) {
  constexpr int kLoads = sizeof(T);          // 16-byte loads a unit
  constexpr int kUnits = 4 / kLoads;         // units a thread a trip
  const float sx = act_scale(plan.amax, plan.eps, plan.inv127);
  const float r = __frcp_rn(sx);
  const bool affine = plan.scale != nullptr;
  const bool relu = plan.relu != 0;
  const unsigned stride = gridDim.x * kThreads * kUnits;
  for (unsigned base = blockIdx.x * kThreads * kUnits + threadIdx.x;
       base < plan.units; base += stride) {
    uint4 raw[kUnits][kLoads];
    int chan[kUnits];  // the unit's first channel; -1: no unit; >= C: padding
    // every load of the trip first
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const unsigned u = base + j * kThreads;
      chan[j] = -1;
      if (u >= plan.units) continue;
      const unsigned p = fast_div(u, plan.groups);
      const int c = static_cast<int>(u - p * plan.groups.d) * kUnit;
      chan[j] = c;
      if (kFlat) {
        load_unit(plan.src[0].ptr + static_cast<long long>(u) * kUnit *
                                        sizeof(T), raw[j]);
        continue;
      }
      if (c >= plan.C) continue;
      const char* ptr = plan.src[0].ptr;
      long long sB = plan.src[0].sB, sH = plan.src[0].sH,
                sW = plan.src[0].sW;
      int c0 = 0;
#pragma unroll
      for (int k = 1; k < kMaxSources; ++k)
        if (k < plan.n_src && c >= plan.src[k].c0) {
          ptr = plan.src[k].ptr;
          sB = plan.src[k].sB; sH = plan.src[k].sH; sW = plan.src[k].sW;
          c0 = plan.src[k].c0;
        }
      const unsigned b = fast_div(p, plan.hw);
      const unsigned rem = p - b * plan.hw.d;
      const unsigned h = fast_div(rem, plan.w);
      const unsigned w = rem - h * plan.w.d;
      const long long off = b * sB + h * sH + w * sW + (c - c0);
      load_unit(ptr + off * static_cast<long long>(sizeof(T)), raw[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int c = chan[j];
      if (c < 0) continue;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (c < plan.C) {
        uint4 sc[kLoads], sh[kLoads];
        if (affine) {
          load_unit(plan.scale + static_cast<long long>(c) * sizeof(T), sc);
          load_unit(plan.shift + static_cast<long long>(c) * sizeof(T), sh);
        }
        out = quantize_unit(raw[j], sc, sh, affine, relu, r, sx);
      }
      const unsigned u = base + j * kThreads;
      *reinterpret_cast<uint4*>(plan.q + static_cast<long long>(u) * kUnit) =
          out;
    }
  }
}

// Tiles: any strides; reads along the pixels; each value's source found
// by its channel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_tile_kernel(const Plan plan) {
  __shared__ uint32_t tile[kTile * kPitch];
  const float sx = act_scale(plan.amax, plan.eps, plan.inv127);
  const float r = __frcp_rn(sx);
  const bool affine = plan.scale != nullptr;
  const bool relu = plan.relu != 0;
  const int P = plan.B * plan.H * plan.W;
  const int p0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  const int t = threadIdx.x;
  // Thread t: pixel pl, the words wd = t / 64 + 4i (channels 4*wd ..).
  const int pl = t % kTile;
  const int p = p0 + pl;
  int b = 0, h = 0, w = 0;
  if (p < P) {
    const int hw = plan.H * plan.W;
    b = p / hw;
    const int r = p - b * hw;
    h = r / plan.W;
    w = r - h * plan.W;
  }
#pragma unroll
  for (int i = 0; i < kTile / 4 / (kThreads / kTile); ++i) {
    const int wd = t / kTile + i * (kThreads / kTile);
    uint32_t word = 0;
    if (p < P) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 4 * wd + k;
        if (c >= plan.C) continue;
        const char* ptr = plan.src[0].ptr;
        long long sB = plan.src[0].sB, sC = plan.src[0].sC,
                  sH = plan.src[0].sH, sW = plan.src[0].sW;
        int first = 0;
#pragma unroll
        for (int n = 1; n < kMaxSources; ++n)
          if (n < plan.n_src && c >= plan.src[n].c0) {
            ptr = plan.src[n].ptr;
            sB = plan.src[n].sB; sC = plan.src[n].sC;
            sH = plan.src[n].sH; sW = plan.src[n].sW;
            first = plan.src[n].c0;
          }
        float v = load_float(reinterpret_cast<const T*>(ptr) + b * sB +
                             h * sH + w * sW + (c - first) * sC);
        float sc = 1.f, sh = 0.f;
        if (affine) {
          sc = load_float(reinterpret_cast<const T*>(plan.scale) + c);
          sh = load_float(reinterpret_cast<const T*>(plan.shift) + c);
        }
        v = prologue<T>(v, sc, sh, affine, relu);
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    quantize(v, r, sx))) << (8 * k);
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
    if (op < P && c < plan.Cp)
      *reinterpret_cast<uint32_t*>(plan.q + static_cast<long long>(op) *
                                                plan.Cp + c) =
          tile[ol * kPitch + wd];
  }
}

// Resident blocks of ``kernel`` on the current device: one wave.
template <typename K>
int wave_blocks(K kernel) {
  static int per_sm[kMaxDevices] = {0};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (per_sm[dev] == 0) {
    int n = 0, blocks = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    sms[dev] = n;
    per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  return sms[dev] * per_sm[dev];
}

template <typename T>
int launch(const Plan& plan, bool rows, bool flat, cudaStream_t s) {
  if (rows) {
    constexpr unsigned per_block = kThreads * (8 / sizeof(T));
    const unsigned need = (plan.units + per_block - 1) / per_block;
    if (flat) {
      const int wave = wave_blocks(quantize_rows_kernel<T, true>);
      if (wave <= 0) return static_cast<int>(cudaGetLastError());
      const unsigned blocks = need < static_cast<unsigned>(wave) ? need : wave;
      quantize_rows_kernel<T, true><<<blocks, kThreads, 0, s>>>(plan);
    } else {
      const int wave = wave_blocks(quantize_rows_kernel<T, false>);
      if (wave <= 0) return static_cast<int>(cudaGetLastError());
      const unsigned blocks = need < static_cast<unsigned>(wave) ? need : wave;
      quantize_rows_kernel<T, false><<<blocks, kThreads, 0, s>>>(plan);
    }
  } else {
    const long long P = static_cast<long long>(plan.B) * plan.H * plan.W;
    const dim3 grid(static_cast<unsigned>((P + kTile - 1) / kTile),
                    (plan.Cp + kTile - 1) / kTile);
    quantize_tile_kernel<T><<<grid, kThreads, 0, s>>>(plan);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// n_src sources (1 .. 5), each 7 int64 of ``desc``: the data pointer, its
// first channel c0 in the concatenation, its channels C_i and its element
// strides (sB, sC, sH, sW), in channel order (c0 = 0, then each c0 the
// previous c0 + C_i); all float32 (x_bf16 0) or bfloat16 (1), each read as
// (B, C_i, H, W). scale, shift: the C per-channel values in the sources'
// dtype, or both null (no affine); relu: 0 or 1; amax: one float32 on the
// device; q: int8 (B, H, W, Cp) contiguous, Cp >= C a multiple of 16,
// 16-byte aligned.
extern "C" int halo_int8_quantize(int n_src, const long long* desc,
                                  int x_bf16, const float* amax,
                                  const void* scale, const void* shift,
                                  int relu, void* q, int B, int H, int W,
                                  int Cp, float eps, float inv127,
                                  void* stream) {
  if (n_src < 1 || n_src > kMaxSources || desc == nullptr || B <= 0 ||
      H <= 0 || W <= 0 || Cp <= 0 || Cp % kUnit != 0 ||
      (scale == nullptr) != (shift == nullptr) || !aligned16(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elem = x_bf16 ? 2 : 4;
  Plan plan{};
  plan.n_src = n_src;
  int C = 0;
  bool rows = true;
  for (int i = 0; i < n_src; ++i) {
    const long long* d = desc + 7 * i;
    Source& src = plan.src[i];
    src.ptr = reinterpret_cast<const char*>(d[0]);
    src.c0 = static_cast<int>(d[1]);
    src.C = static_cast<int>(d[2]);
    src.sB = d[3]; src.sC = d[4]; src.sH = d[5]; src.sW = d[6];
    if (src.ptr == nullptr || src.c0 != C || src.C <= 0 || d[2] > Cp)
      return static_cast<int>(cudaErrorInvalidValue);
    C += src.C;
    rows = rows && src.sC == 1 && src.C % kUnit == 0 && aligned16(src.ptr) &&
           (src.sB * elem) % 16 == 0 && (src.sH * elem) % 16 == 0 &&
           (src.sW * elem) % 16 == 0;
  }
  const long long P = static_cast<long long>(B) * H * W;
  if (C > Cp || P + kTile >= (1LL << 31) || P * (Cp / kUnit) >= (1LL << 31) ||
      (Cp + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  rows = rows && (scale == nullptr || (aligned16(scale) && aligned16(shift)));
  const Source& s0 = plan.src[0];
  const bool flat = rows && n_src == 1 && C == Cp && s0.sW == C &&
                    (H == 1 || s0.sH == static_cast<long long>(W) * C) &&
                    (B == 1 || s0.sB == P / B * C);
  plan.C = C;
  plan.Cp = Cp;
  plan.B = B;
  plan.H = H;
  plan.W = W;
  plan.units = static_cast<unsigned>(P * (Cp / kUnit));
  plan.groups = make_fastdiv(static_cast<unsigned>(Cp / kUnit));
  plan.hw = make_fastdiv(static_cast<unsigned>(H * W));
  plan.w = make_fastdiv(static_cast<unsigned>(W));
  plan.amax = amax;
  plan.scale = static_cast<const char*>(scale);
  plan.shift = static_cast<const char*>(shift);
  plan.relu = relu != 0;
  plan.q = static_cast<int8_t*>(q);
  plan.eps = eps;
  plan.inv127 = inv127;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch<__nv_bfloat16>(plan, rows, flat, s);
  return launch<float>(plan, rows, flat, s);
}
