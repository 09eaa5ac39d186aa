// The fused photometric augmentation, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/augment_pallas.py:_photometric_kernel (K5, launched
// by pallas_photometric_batch). On every (image, channel) plane of a
// (B, H, W, 3) float32 batch on the 0-255 scale, already flipped:
//   x = x * alpha + beta;
//   x = x + sigma * n, n = sqrt(-2 log u1) cos(2 pi u2), u1 and u2 the top
//       24 bits of murmur3-mixed counters idx ^ seed and (idx ^ seed) +
//       0x68E31DA4, idx = r * W + c, seed = mix(seeds[3 b + ch] * 0x9E3779B9);
//   x = glass ? 5x5 Gaussian(x) : x, a vertical then a horizontal 5-tap pass;
//   x = motion ? sum_t w_t x[r + dy_t, c + dx_t] : x, the direction's taps;
//   out = clip(x, 0, 255) / 255.
// Both blurs read zero outside the image. The scalars table is fdtpu's
// (B, 8) [flip, alpha, beta, sigma, glass, motion, direction bin, 0]; the
// Gaussian and motion taps come from the Python side in the launch's
// parameters, so both versions use one table.
//
// Exactness against the plain PyTorch version: every multiply, add and
// divide is a round-to-nearest intrinsic (and the build passes -fmad=false),
// sums run in the TPU kernel's order, the clip divides by 255 (no reciprocal),
// and murmur3 is integer arithmetic. u = (bits >> 8) * 2^-24 equals the
// division by 2^24: the numerator is below 2^24 and the divisor a power of
// two. The noise also goes through logf, cosf and the correctly rounded
// sqrt; a plane with sigma 0 skips it, which gives x + 0 * n = x as the
// plain version's multiply does.
//
// What bounds it on this card: bytes. Each pixel is read once and written
// once in float32 (a b128 320 px batch moves 315 MB; the noise, ~80 flops a
// noised pixel, is below the bandwidth line). One CTA per (image, 32x32
// tile); what the design does about the bytes:
// - The CTA reads its image's glass and motion gates. With both off (76 of
//   the 128 images on the fused route's table, the noised ones among them)
//   it needs no neighbour: it runs an elementwise pass over its share of
//   the image's flat NHWC buffer with 16-byte float4 loads and stores, no
//   shared memory and no barrier. The choice is made on the card, per CTA,
//   with no host synchronisation. An index p of the flat buffer is pixel
//   p / 3, channel p % 3, so the noise counter needs no row or column.
// - A blurred CTA stages its tile and a 5-pixel halo (the Gaussian reads
//   +-2, the motion taps +-3 of its output) of all three channels in shared
//   memory, interleaved [row][column][channel] as NHWC has them: a window row
//   is 126 contiguous floats of one image row. With W a multiple of 4 (the
//   main path's 320 and 480) every row sits at one offset from the 16-byte
//   grid: each row is loaded as the aligned float4 chunks that cover it,
//   six in flight a thread, and stored to shared memory as float4 at the
//   same alignment (the row's first float at offset 0-3 of a 132-float
//   shared row); other widths stage float by float. Staging and every tap
//   pass read and write consecutive floats across a warp, free of bank
//   conflicts, and address shared memory by arithmetic alone. The motion
//   pass holds 12 outputs a thread and runs each tap over all of them, so a
//   tap's weight and offset are read once and 12 sums run side by side.
//   Brightness/contrast and the noise apply while staging; outside the image
//   the value is 0, set after them.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 5;
constexpr int kReg = kTile + 2 * kHalo;  // staged rows and pixel columns
constexpr int kRow = 3 * kReg;           // floats of a staged row (126)
constexpr int kChunks = (kRow + 3 + 3) / 4;  // float4 chunks that cover a row at any offset
constexpr int kStride = 4 * kChunks;     // floats a shared row holds (132)
constexpr int kInner = kReg - 4;         // rows/columns the Gaussian produces
constexpr int kThreads = 256;
constexpr int kStage = kReg * kChunks;   // staging tasks: (row, chunk)
constexpr int kStagePer = (kStage + kThreads - 1) / kThreads;
constexpr int kOut = 3 * kTile;                      // floats of a tile's output row
constexpr int kOutPer = kTile * kOut / kThreads;     // outputs a thread (12)
static_assert(kTile * kOut % kThreads == 0, "every thread holds kOutPer outputs");
constexpr int kVecPer = kTile * kTile * 3 / 4 / kThreads;  // float4 a thread, halo-free (3)
constexpr int kDirs = 16;
constexpr int kMaxTaps = 16;
constexpr int kScalars = 8;

struct Taps {
  float gauss[5];
  int count[kDirs];
  float w[kDirs][kMaxTaps];
  short delta[kDirs][kMaxTaps];  // dy * kStride + 3 dx: the tap's shared-memory offset
};

__device__ __forceinline__ uint32_t mix(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// Box-Muller normal of one counter.
__device__ __forceinline__ float normal(uint32_t idx, uint32_t seed) {
  const uint32_t z = idx ^ seed;
  const uint32_t bits1 = mix(z), bits2 = mix(z + 0x68E31DA4u);
  const float u1 = fmaxf(__fmul_rn(static_cast<float>(bits1 >> 8), 0x1p-24f), 1e-7f);
  const float u2 = __fmul_rn(static_cast<float>(bits2 >> 8), 0x1p-24f);
  const float two_pi = 0x1.921fb6p+2f;  // float32(2 pi)
  return __fmul_rn(__fsqrt_rn(__fmul_rn(-2.f, logf(u1))), cosf(__fmul_rn(two_pi, u2)));
}

// One image's per-plane parameters.
struct Plane {
  float alpha, beta, sigma;
  uint32_t s0, s1, s2;  // the three channels' mixed seeds

  // brightness/contrast and noise of element i of the image's flat NHWC
  // buffer (pixel i / 3, channel i % 3)
  __device__ __forceinline__ float point(float v, int i) const {
    float x = __fadd_rn(__fmul_rn(v, alpha), beta);
    if (sigma != 0.f) {
      const int p = i / 3, ch = i - 3 * p;
      const uint32_t seed = ch == 0 ? s0 : (ch == 1 ? s1 : s2);
      x = __fadd_rn(x, __fmul_rn(sigma, normal(static_cast<uint32_t>(p), seed)));
    }
    return x;
  }
};

__device__ __forceinline__ float finish(float y) {
  return __fdiv_rn(fminf(fmaxf(y, 0.f), 255.f), 255.f);
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Both blurs off: floats [lo, hi) of the image at `img` (a flat offset), the
// 16-byte aligned middle as float4, the ragged ends one by one.
__device__ void elementwise(const float* __restrict__ in, float* __restrict__ out, int img,
                            int lo, int hi, const Plane& pl) {
  const int a = min(hi, ((img + lo + 3) & ~3) - img);  // first aligned index
  const int z = max(a, ((img + hi) & ~3) - img);       // end of the aligned body
  for (int i = lo + threadIdx.x; i < a; i += kThreads) {
    out[img + i] = finish(pl.point(in[img + i], i));
  }
  for (int i = z + threadIdx.x; i < hi; i += kThreads) {
    out[img + i] = finish(pl.point(in[img + i], i));
  }
  // every load of a round in flight before the first store: one float4 at
  // a time leaves too few bytes in flight at the 5 CTAs an SM holds
  const int nv = (z - a) / 4;
  for (int v0 = 0; v0 < nv; v0 += kVecPer * kThreads) {
    float4 v[kVecPer];
#pragma unroll
    for (int k = 0; k < kVecPer; ++k) {
      const int q = v0 + threadIdx.x + k * kThreads;
      if (q < nv) v[k] = __ldg(reinterpret_cast<const float4*>(in + img + a) + q);
    }
#pragma unroll
    for (int k = 0; k < kVecPer; ++k) {
      const int q = v0 + threadIdx.x + k * kThreads, i = a + 4 * q;
      if (q >= nv) continue;
      float4 y;
      y.x = finish(pl.point(v[k].x, i));
      y.y = finish(pl.point(v[k].y, i + 1));
      y.z = finish(pl.point(v[k].z, i + 2));
      y.w = finish(pl.point(v[k].w, i + 3));
      *reinterpret_cast<float4*>(out + img + i) = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    photometric_kernel(const float* __restrict__ in, float* __restrict__ out,
                       const float* __restrict__ scalars, const int* __restrict__ seeds,
                       int h, int w, int tiles_x, int chunk, int total,
                       const __grid_constant__ Taps taps) {
  __shared__ __align__(16) float sx[kReg * kStride];  // x, then the glass output
  __shared__ float sv[kInner * kRow];                 // the vertical Gaussian pass
  const int b = blockIdx.y;
  const float* sc = scalars + static_cast<size_t>(b) * kScalars;
  Plane pl;
  pl.alpha = sc[1];
  pl.beta = sc[2];
  pl.sigma = sc[3];
  pl.s0 = mix(static_cast<uint32_t>(seeds[3 * b]) * 0x9E3779B9u);
  pl.s1 = mix(static_cast<uint32_t>(seeds[3 * b + 1]) * 0x9E3779B9u);
  pl.s2 = mix(static_cast<uint32_t>(seeds[3 * b + 2]) * 0x9E3779B9u);
  const bool glass = sc[4] > 0.5f, motion = sc[5] > 0.5f;
  const int img = b * h * w * 3;  // total < 2^31

  if (!glass && !motion) {  // uniform over the CTA: no barrier is skipped
    const int lo = blockIdx.x * chunk, hi = min(lo + chunk, h * w * 3);
    if (lo < hi) elementwise(in, out, img, lo, hi, pl);
    return;
  }

  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int r0 = ty * kTile - kHalo, c0 = tx * kTile - kHalo;
  // float -> int truncates, and lax.switch clamps its index: clamp first
  const int dir = static_cast<int>(fminf(fmaxf(sc[6], 0.f), static_cast<float>(kDirs - 1)));

  // 1. stage: staged row rr is image row r = r0 + rr, the window's floats
  // [s, s + kRow) of the flat buffer, s = img + (r * w + c0) * 3; [lo, hi) of
  // them lie in the image, the rest is 0. Float j of staged row rr lives at
  // sx[rr * kStride + off + j]. With w a multiple of 4 every row sits at the
  // same offset off = s & 3 from the 16-byte grid, and the float4 chunks
  // from s - off go to sx[rr * kStride + 4 q] whole; otherwise (off = 0) the
  // floats go one by one.
  const bool chunked = (w & 3) == 0;
  const int off = chunked ? (img + c0 * 3) & 3 : 0;
  if (chunked) {
    float4 fetched[kStagePer];
#pragma unroll
    for (int k = 0; k < kStagePer; ++k) {
      const int t = threadIdx.x + k * kThreads;
      fetched[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= kStage) continue;
      const int rr = t / kChunks, q = t - rr * kChunks, r = r0 + rr;
      if (r < 0 || r >= h) continue;
      const int s = img + (r * w + c0) * 3;
      const int lo = max(s, img + r * w * 3), hi = min(s + kRow, img + (r + 1) * w * 3);
      const int g = s - off + 4 * q;
      if (g >= hi || g + 4 <= lo) continue;
      if (g + 4 <= total) {
        fetched[k] = __ldg(reinterpret_cast<const float4*>(in + g));
      } else {  // the buffer's last, partial chunk
        fetched[k].x = in[g];
        if (g + 1 < total) fetched[k].y = in[g + 1];
        if (g + 2 < total) fetched[k].z = in[g + 2];
      }
    }
#pragma unroll
    for (int k = 0; k < kStagePer; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t >= kStage) continue;
      const int rr = t / kChunks, q = t - rr * kChunks, r = r0 + rr;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r >= 0 && r < h) {
        const int s = img + (r * w + c0) * 3;
        const int lo = max(s, img + r * w * 3), hi = min(s + kRow, img + (r + 1) * w * 3);
        const int g = s - off + 4 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (g + e >= lo && g + e < hi) v[e] = pl.point(lane(fetched[k], e), g + e - img);
        }
      }
      *reinterpret_cast<float4*>(sx + rr * kStride + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int t = threadIdx.x; t < kReg * kRow; t += kThreads) {
      const int rr = t / kRow, j = t - rr * kRow, r = r0 + rr, c = c0 + j / 3;
      float v = 0.f;
      if (r >= 0 && r < h && c >= 0 && c < w) {
        const int g = img + (r * w + c0) * 3 + j;
        v = pl.point(in[g], g - img);
      }
      sx[rr * kStride + j] = v;
    }
  }
  __syncthreads();

  // 2. the Gaussian: tap j reads x[i + 2 - j], summed left to right
  if (glass) {
    const float g0 = taps.gauss[0], g1 = taps.gauss[1], g2 = taps.gauss[2],
                g3 = taps.gauss[3], g4 = taps.gauss[4];
    // vertical pass on rows [2, kReg - 2), every column (0 in the columns
    // outside the image, whose staged values are all 0)
    for (int i = threadIdx.x; i < kInner * kRow; i += kThreads) {
      const int t = i / kRow, j = i - t * kRow;
      const float* x = sx + (2 + t) * kStride + off + j;
      float v = __fmul_rn(g0, x[2 * kStride]);
      v = __fadd_rn(v, __fmul_rn(g1, x[kStride]));
      v = __fadd_rn(v, __fmul_rn(g2, x[0]));
      v = __fadd_rn(v, __fmul_rn(g3, x[-kStride]));
      v = __fadd_rn(v, __fmul_rn(g4, x[-2 * kStride]));
      sv[i] = v;
    }
    __syncthreads();
    // horizontal pass on rows and columns [2, kReg - 2), 0 outside the
    // image; a pixel's neighbour is 3 floats away
    constexpr int kCols = 3 * kInner;
    for (int i = threadIdx.x; i < kInner * kCols; i += kThreads) {
      const int t = i / kCols, j = 6 + (i - t * kCols);
      const int r = r0 + 2 + t, c = c0 + j / 3;
      const float* x = sv + t * kRow + j;
      float g = 0.f;
      if (r >= 0 && r < h && c >= 0 && c < w) {
        g = __fmul_rn(g0, x[6]);
        g = __fadd_rn(g, __fmul_rn(g1, x[3]));
        g = __fadd_rn(g, __fmul_rn(g2, x[0]));
        g = __fadd_rn(g, __fmul_rn(g3, x[-3]));
        g = __fadd_rn(g, __fmul_rn(g4, x[-6]));
      }
      sx[(2 + t) * kStride + off + j] = g;
    }
    __syncthreads();
  }

  // 3. the motion taps, clip, /255, NHWC store along the tile's rows. Each
  // thread holds kOutPer outputs and runs the taps over all of them, so a
  // tap's weight and offset are read once and the sums run side by side.
  int at[kOutPer];
  float y[kOutPer];
#pragma unroll
  for (int k = 0; k < kOutPer; ++k) {
    const int i = threadIdx.x + k * kThreads, tr = i / kOut, jj = i - tr * kOut;
    at[k] = (kHalo + tr) * kStride + off + 3 * kHalo + jj;
    y[k] = motion ? 0.f : sx[at[k]];
  }
  if (motion) {
    const int ntaps = taps.count[dir];
    for (int t = 0; t < ntaps; ++t) {
      const float wt = taps.w[dir][t];
      const int d = taps.delta[dir][t];
#pragma unroll
      for (int k = 0; k < kOutPer; ++k) y[k] = __fadd_rn(y[k], __fmul_rn(wt, sx[at[k] + d]));
    }
  }
#pragma unroll
  for (int k = 0; k < kOutPer; ++k) {
    const int i = threadIdx.x + k * kThreads, tr = i / kOut, jj = i - tr * kOut;
    const int r = r0 + kHalo + tr, c = c0 + kHalo + jj / 3;
    if (r < h && c < w) out[img + (r * w + c0 + kHalo) * 3 + jj] = finish(y[k]);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: `in`, `out` (b, h, w, 3) f32 contiguous and 16-byte
// aligned on the card, `scalars` (b, 8) f32 and `seeds` (3 b,) i32 on the
// card; `gauss` (5,), `counts` (16,), `weights` (16, 16) and `offsets`
// (16, 16, 2) [dy, dx] in host memory, copied into the launch. Returns the
// cudaError_t of the launch (0 on success).
int fdtpu_photometric(const void* in, void* out, const void* scalars, const void* seeds,
                      int b, int h, int w, const float* gauss, const int* counts,
                      const float* weights, const int* offsets, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(b) * h * w * 3 >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) {
    return cudaErrorMisalignedAddress;
  }
  Taps taps;
  for (int j = 0; j < 5; ++j) taps.gauss[j] = gauss[j];
  for (int k = 0; k < kDirs; ++k) {
    if (counts[k] < 0 || counts[k] > kMaxTaps) return cudaErrorInvalidValue;
    taps.count[k] = counts[k];
    for (int t = 0; t < kMaxTaps; ++t) {
      const int dy = offsets[(k * kMaxTaps + t) * 2], dx = offsets[(k * kMaxTaps + t) * 2 + 1];
      if (dy < -3 || dy > 3 || dx < -3 || dx > 3) return cudaErrorInvalidValue;
      taps.w[k][t] = weights[k * kMaxTaps + t];
      taps.delta[k][t] = static_cast<short>(dy * kStride + 3 * dx);
    }
  }
  const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
  const int tiles = tiles_x * tiles_y;
  // a blur-free image's share of its flat buffer a CTA, a multiple of 4
  const int chunk = ((h * w * 3 + tiles - 1) / tiles + 3) & ~3;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(b));
  photometric_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(scalars), static_cast<const int*>(seeds), h, w, tiles_x, chunk,
      b * h * w * 3, taps);
  return cudaGetLastError();
}

}  // extern "C"
