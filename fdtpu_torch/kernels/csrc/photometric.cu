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
// and murmur3 is integer arithmetic. The noise also goes through logf, cosf
// and the correctly rounded sqrt; a plane with sigma 0 skips it, which gives
// x + 0 * n = x as the plain version's multiply does.
//
// What bounds it on this card: bytes. Each pixel is read once and written
// once in float32 (a b128 320 px batch moves 315 MB; the noise, ~80 flops a
// noised pixel, is below the bandwidth line). What the design does about
// it: one pass instead of fdtpu's HBM round trips and its two transposes
// (the kernel reads and writes NHWC directly). One CTA per (image, 32x32
// tile) holds the tile and a 5-pixel halo of all three channels in shared
// memory (the Gaussian reads +-2, the motion taps +-3 of its output), so
// loads and stores run along contiguous image rows and each intermediate
// stays on chip. Vector loads and trimming the halo recompute are later
// work.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 5;
constexpr int kReg = kTile + 2 * kHalo;  // staged rows and columns
constexpr int kInner = kReg - 4;         // rows/columns the Gaussian produces
constexpr int kThreads = 256;
constexpr int kDirs = 16;
constexpr int kMaxTaps = 16;
constexpr int kScalars = 8;

struct Taps {
  float gauss[5];
  int count[kDirs];
  float w[kDirs][kMaxTaps];
  signed char dy[kDirs][kMaxTaps];
  signed char dx[kDirs][kMaxTaps];
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
  const float u1 = fmaxf(__fdiv_rn(static_cast<float>(bits1 >> 8), 16777216.f), 1e-7f);
  const float u2 = __fdiv_rn(static_cast<float>(bits2 >> 8), 16777216.f);
  const float two_pi = 0x1.921fb6p+2f;  // float32(2 pi)
  return __fmul_rn(__fsqrt_rn(__fmul_rn(-2.f, logf(u1))), cosf(__fmul_rn(two_pi, u2)));
}

__global__ void __launch_bounds__(kThreads)
    photometric_kernel(const float* __restrict__ in, float* __restrict__ out,
                       const float* __restrict__ scalars, const int* __restrict__ seeds,
                       int h, int w, int tiles_x, const __grid_constant__ Taps taps) {
  __shared__ float sx[3][kReg][kReg];  // x, then the glass output
  __shared__ float sv[3][kReg][kReg];  // the vertical Gaussian pass
  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int r0 = ty * kTile - kHalo, c0 = tx * kTile - kHalo;
  const float* sc = scalars + static_cast<size_t>(b) * kScalars;
  const float alpha = sc[1], beta = sc[2], sigma = sc[3];
  const bool glass = sc[4] > 0.5f, motion = sc[5] > 0.5f;
  // float -> int truncates, and lax.switch clamps its index: clamp first
  const int dir = static_cast<int>(fminf(fmaxf(sc[6], 0.f), static_cast<float>(kDirs - 1)));
  const uint32_t s0 = mix(static_cast<uint32_t>(seeds[3 * b]) * 0x9E3779B9u);
  const uint32_t s1 = mix(static_cast<uint32_t>(seeds[3 * b + 1]) * 0x9E3779B9u);
  const uint32_t s2 = mix(static_cast<uint32_t>(seeds[3 * b + 2]) * 0x9E3779B9u);
  const size_t img = static_cast<size_t>(b) * h * w * 3;

  // 1. brightness/contrast and noise on the tile and its halo, 0 outside
  for (int i = threadIdx.x; i < kReg * kReg * 3; i += kThreads) {
    const int ch = i % 3, p = i / 3, rr = p / kReg, cc = p - rr * kReg;
    const int r = r0 + rr, c = c0 + cc;
    float x = 0.f;
    if (r >= 0 && r < h && c >= 0 && c < w) {
      const float v = in[img + (static_cast<size_t>(r) * w + c) * 3 + ch];
      x = __fadd_rn(__fmul_rn(v, alpha), beta);
      if (sigma != 0.f) {
        const uint32_t seed = ch == 0 ? s0 : (ch == 1 ? s1 : s2);
        x = __fadd_rn(x, __fmul_rn(sigma, normal(static_cast<uint32_t>(r * w + c), seed)));
      }
    }
    sx[ch][rr][cc] = x;
  }
  __syncthreads();

  // 2. the Gaussian: tap j reads x[i + 2 - j], summed left to right
  if (glass) {
    const float g0 = taps.gauss[0], g1 = taps.gauss[1], g2 = taps.gauss[2],
                g3 = taps.gauss[3], g4 = taps.gauss[4];
    // vertical pass on rows [2, kReg - 2), every column; 0 in columns outside
    for (int i = threadIdx.x; i < 3 * kInner * kReg; i += kThreads) {
      const int cc = i % kReg, t = i / kReg, rr = 2 + t % kInner, ch = t / kInner;
      const int c = c0 + cc;
      float v = 0.f;
      if (c >= 0 && c < w) {
        v = __fmul_rn(g0, sx[ch][rr + 2][cc]);
        v = __fadd_rn(v, __fmul_rn(g1, sx[ch][rr + 1][cc]));
        v = __fadd_rn(v, __fmul_rn(g2, sx[ch][rr][cc]));
        v = __fadd_rn(v, __fmul_rn(g3, sx[ch][rr - 1][cc]));
        v = __fadd_rn(v, __fmul_rn(g4, sx[ch][rr - 2][cc]));
      }
      sv[ch][rr][cc] = v;
    }
    __syncthreads();
    // horizontal pass on rows and columns [2, kReg - 2), 0 outside the image
    for (int i = threadIdx.x; i < 3 * kInner * kInner; i += kThreads) {
      const int cc = 2 + i % kInner, t = i / kInner, rr = 2 + t % kInner, ch = t / kInner;
      const int r = r0 + rr, c = c0 + cc;
      float g = 0.f;
      if (r >= 0 && r < h && c >= 0 && c < w) {
        g = __fmul_rn(g0, sv[ch][rr][cc + 2]);
        g = __fadd_rn(g, __fmul_rn(g1, sv[ch][rr][cc + 1]));
        g = __fadd_rn(g, __fmul_rn(g2, sv[ch][rr][cc]));
        g = __fadd_rn(g, __fmul_rn(g3, sv[ch][rr][cc - 1]));
        g = __fadd_rn(g, __fmul_rn(g4, sv[ch][rr][cc - 2]));
      }
      sx[ch][rr][cc] = g;
    }
    __syncthreads();
  }

  // 3. the motion taps, clip, /255, NHWC store
  const int ntaps = taps.count[dir];
  for (int i = threadIdx.x; i < kTile * kTile * 3; i += kThreads) {
    const int ch = i % 3, p = i / 3, tr = p / kTile, tc = p - tr * kTile;
    const int r = r0 + kHalo + tr, c = c0 + kHalo + tc;
    if (r >= h || c >= w) continue;
    const int rr = kHalo + tr, cc = kHalo + tc;
    float y = sx[ch][rr][cc];
    if (motion) {
      float acc = 0.f;
      for (int t = 0; t < ntaps; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(taps.w[dir][t],
                                       sx[ch][rr + taps.dy[dir][t]][cc + taps.dx[dir][t]]));
      }
      y = acc;
    }
    out[img + (static_cast<size_t>(r) * w + c) * 3 + ch] =
        __fdiv_rn(fminf(fmaxf(y, 0.f), 255.f), 255.f);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: `in`, `out` (b, h, w, 3) f32 contiguous on the card,
// `scalars` (b, 8) f32 and `seeds` (3 b,) i32 on the card; `gauss` (5,),
// `counts` (16,), `weights` (16, 16) and `offsets` (16, 16, 2) [dy, dx] in
// host memory, copied into the launch. Returns the cudaError_t of the launch
// (0 on success).
int fdtpu_photometric(const void* in, void* out, const void* scalars, const void* seeds,
                      int b, int h, int w, const float* gauss, const int* counts,
                      const float* weights, const int* offsets, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1) return cudaErrorInvalidValue;
  Taps taps;
  for (int j = 0; j < 5; ++j) taps.gauss[j] = gauss[j];
  for (int k = 0; k < kDirs; ++k) {
    if (counts[k] < 0 || counts[k] > kMaxTaps) return cudaErrorInvalidValue;
    taps.count[k] = counts[k];
    for (int t = 0; t < kMaxTaps; ++t) {
      const int dy = offsets[(k * kMaxTaps + t) * 2], dx = offsets[(k * kMaxTaps + t) * 2 + 1];
      if (dy < -3 || dy > 3 || dx < -3 || dx > 3) return cudaErrorInvalidValue;
      taps.w[k][t] = weights[k * kMaxTaps + t];
      taps.dy[k][t] = static_cast<signed char>(dy);
      taps.dx[k][t] = static_cast<signed char>(dx);
    }
  }
  const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles_x) * static_cast<unsigned>(tiles_y),
                  static_cast<unsigned>(b));
  photometric_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(scalars), static_cast<const int*>(seeds), h, w, tiles_x, taps);
  return cudaGetLastError();
}

}  // extern "C"
