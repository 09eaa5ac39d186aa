// The fused residual-block tail, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/epilogue_pallas.py:_tail_kernel (K6, launched by
// fused_residual_tail): out = maxpool2x2(leaky(y0, 0.2) + skip), or the same
// without the pool, where y0 = c2, or c2 + bias[channel] when the caller
// folds the preceding convolution's bias in. (N, C, H, W) tensors in
// channels_last or contiguous NCHW memory, float32 or bfloat16.
//
// Exactness against the plain PyTorch version (the port's eager ops: the
// bias add that follows cuDNN's convolution, F.leaky_relu, +, F.max_pool2d):
// each eager op computes in float32 and rounds its result to the tensor's
// type, so here
//   y0 = round(c2 + bias), y = round(y0 > 0 ? y0 : y0 * 0.2f),
//   y = round(float(y) + float(skip)),
// then the 2x2 window's max, scanned row by row from -inf, where a later
// value replaces the max only when it is greater or NaN (max_pool2d's rule).
// The multiply and adds are round-to-nearest intrinsics under -fmad=false.
// fdtpu's bf16 kernel multiplies by 0.2 rounded to bf16 instead, so the port
// may differ from fdtpu by one bf16 step on negative inputs; it is held to
// its own eager ops.
//
// What bounds it on this card: bytes. At b128, 128 channels, bf16, a pooled
// 40x40 -> 20x20 block reads 105 MB and writes 13 MB, an unpooled 20x20
// block reads 26 MB and writes 13 MB; ~3 flops an input. The design moves
// every byte in 16-byte vectors and decodes no index per element:
// - unpooled: c2, skip and out share one dense memory order, so the tail is
//   an elementwise pass over the flat buffers. Each thread moves 16 bytes
//   (8 bf16 or 4 f32) a step with uint4 loads and stores, in a grid-stride
//   loop sized to the SMs. A base pointer that is not 16-byte aligned and a
//   numel that is not a multiple of the width take a scalar loop over the
//   ragged head and tail in the same kernel. The bias channel is decoded
//   once per vector and stepped per lane.
// - pooled, channels_last: one thread per (n, ho, wo, 16-byte channel
//   group): n, ho from blockIdx.z/y, wo from blockIdx.x and threadIdx.y, the
//   group from threadIdx.x, so there is no division. Four 16-byte loads from
//   c2 and four from skip, one 16-byte store; neighbouring threads sit on
//   neighbouring groups, so each warp access is contiguous. With C not a
//   multiple of the width, or a pointer not 16-byte aligned, the same
//   threads load their channels one by one.
// - pooled, contiguous NCHW (on no serving path): one thread per output,
//   the plane and the output row from blockIdx, the column from threadIdx.
// Folding the bias in saves the eager bias add's read and write of c2.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads fill an SM
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of T as floats and back; a value already rounded to T packs exactly
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2k is the low half of word k; bf16 -> f32 is a 16-bit shift
  __device__ static void unpack_word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static uint32_t pack_word(const float* f) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[0]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[1]))) << 16);
  }
  __device__ static void unpack(const uint4& u, float* f) {
    unpack_word(u.x, f);
    unpack_word(u.y, f + 2);
    unpack_word(u.z, f + 4);
    unpack_word(u.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack_word(f), pack_word(f + 2), pack_word(f + 4), pack_word(f + 6));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// round(leaky(round(x + bias)) + skip), each op rounded to T as the eager
// ops round
template <typename T, bool kBias>
__device__ __forceinline__ float tail(float x, float skip, float bias) {
  if (kBias) x = round_to(__fadd_rn(x, bias), T());
  const float y = round_to(x > 0.f ? x : __fmul_rn(x, 0.2f), T());
  return round_to(__fadd_rn(y, skip), T());
}

// max_pool2d's scan: a later value replaces the max when greater or NaN
__device__ __forceinline__ float pool_max(float m, float v) { return (v > m || isnan(v)) ? v : m; }

// The channel of flat element i and a cheap step to element i + 1.
struct Channel {
  int ch, pos;  // pos: the index within the (h, w) plane (NCHW only)
  __device__ Channel(int i, int c, int hw, bool channels_last) {
    if (channels_last) {
      ch = i % c;
      pos = 0;
    } else {
      const int plane = i / hw;
      ch = plane % c;
      pos = i - plane * hw;
    }
  }
  __device__ void step(int c, int hw, bool channels_last) {
    if (!channels_last && ++pos < hw) return;
    pos = 0;
    if (++ch == c) ch = 0;
  }
};

// Unpooled: elements [0, head) and [head + nvec * N, n) one by one,
// [head, head + nvec * N) in 16-byte vectors.
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
    tail_flat_kernel(const T* __restrict__ c2, const T* __restrict__ skip, T* __restrict__ out,
                     const T* __restrict__ bias, int n, int head, int nvec, int c, int hw,
                     int channels_last) {
  constexpr int N = Vec<T>::N;
  const int tid = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  for (int v = tid; v < nvec; v += stride) {
    const int i = head + v * N;
    const uint4 a = load16(c2 + i), s = load16(skip + i);
    float fa[N], fs[N], fb[N];
    Vec<T>::unpack(a, fa);
    Vec<T>::unpack(s, fs);
    if (kBias) {
      Channel at(i, c, hw, channels_last);
#pragma unroll
      for (int l = 0; l < N; ++l) {
        fb[l] = to_float(bias[at.ch]);
        at.step(c, hw, channels_last);
      }
    }
#pragma unroll
    for (int l = 0; l < N; ++l) fa[l] = tail<T, kBias>(fa[l], fs[l], kBias ? fb[l] : 0.f);
    *reinterpret_cast<uint4*>(out + i) = Vec<T>::pack(fa);
  }
  const int ragged = n - nvec * N;
  for (int k = tid; k < ragged; k += stride) {
    const int i = k < head ? k : k + nvec * N;
    const float b = kBias ? to_float(bias[Channel(i, c, hw, channels_last).ch]) : 0.f;
    store(out + i, tail<T, kBias>(to_float(c2[i]), to_float(skip[i]), b));
  }
}

// Pooled, channels_last: threadIdx.x strides over the 16-byte channel
// groups, wo = blockIdx.x * blockDim.y + threadIdx.y, ho = blockIdx.y,
// n = blockIdx.z. kVec: C a multiple of N and every pointer 16-byte aligned.
template <typename T, bool kBias, bool kVec>
__global__ void __launch_bounds__(2 * kThreads)
    tail_pool_cl_kernel(const T* __restrict__ c2, const T* __restrict__ skip,
                        T* __restrict__ out, const T* __restrict__ bias, int c, int h, int w,
                        int groups) {
  constexpr int N = Vec<T>::N;
  const int wo_n = w / 2;
  const int wo = blockIdx.x * blockDim.y + threadIdx.y, ho = blockIdx.y, n = blockIdx.z;
  if (wo >= wo_n) return;
  const size_t top = ((static_cast<size_t>(n) * h + 2 * ho) * w + 2 * wo) * c;
  const size_t window[4] = {top, top + c, top + static_cast<size_t>(w) * c,
                            top + static_cast<size_t>(w) * c + c};
  const size_t dst = ((static_cast<size_t>(n) * (h / 2) + ho) * wo_n + wo) * c;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int ch0 = g * N;
    float m[N], fb[N];
#pragma unroll
    for (int l = 0; l < N; ++l) m[l] = -INFINITY;
    if (kVec) {
      uint4 a[4], s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = load16(c2 + window[k] + ch0);
        s[k] = load16(skip + window[k] + ch0);
      }
      if (kBias) Vec<T>::unpack(load16(bias + ch0), fb);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float fa[N], fs[N];
        Vec<T>::unpack(a[k], fa);
        Vec<T>::unpack(s[k], fs);
#pragma unroll
        for (int l = 0; l < N; ++l) {
          m[l] = pool_max(m[l], tail<T, kBias>(fa[l], fs[l], kBias ? fb[l] : 0.f));
        }
      }
      *reinterpret_cast<uint4*>(out + dst + ch0) = Vec<T>::pack(m);
    } else {
      const int lanes = min(N, c - ch0);
      for (int l = 0; l < lanes; ++l) {
        const float b = kBias ? to_float(bias[ch0 + l]) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t at = window[k] + ch0 + l;
          m[l] = pool_max(m[l], tail<T, kBias>(to_float(c2[at]), to_float(skip[at]), b));
        }
        store(out + dst + ch0 + l, m[l]);
      }
    }
  }
}

// Pooled, contiguous NCHW: blockIdx.y strides over the (n, c) planes,
// blockIdx.x is the output row, threadIdx.x strides over its columns.
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
    tail_pool_nchw_kernel(const T* __restrict__ c2, const T* __restrict__ skip,
                          T* __restrict__ out, const T* __restrict__ bias, int c, int h, int w,
                          int planes) {
  const int ho = blockIdx.x, wo_n = w / 2;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const float b = kBias ? to_float(bias[plane % c]) : 0.f;
    const size_t top = (static_cast<size_t>(plane) * h + 2 * ho) * w;
    const size_t dst = (static_cast<size_t>(plane) * (h / 2) + ho) * wo_n;
    for (int wo = threadIdx.x; wo < wo_n; wo += blockDim.x) {
      const size_t at = top + 2 * wo;
      const size_t window[4] = {at, at + 1, at + w, at + w + 1};
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m = pool_max(m, tail<T, kBias>(to_float(c2[window[k]]), to_float(skip[window[k]]), b));
      }
      store(out + dst + wo, m);
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    counts[dev] = 132;
  }
  return counts[dev];
}

uintptr_t misalignment(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

template <typename T, bool kBias>
int launch(const T* c2, const T* skip, T* out, const T* bias, int n, int c, int h, int w,
           int pool, int channels_last, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int total = n * c * h * w;  // the caller checked that it is below 2^31
  if (total == 0) return cudaSuccess;
  if (!pool) {
    // the vector body needs c2, skip and out equally far from a 16-byte
    // boundary; otherwise every element takes the scalar loop
    const uintptr_t mis = misalignment(c2);
    int head = total, nvec = 0;
    if (misalignment(skip) == mis && misalignment(out) == mis) {
      head = std::min(total, static_cast<int>(((16 - mis) & 15) / sizeof(T)));
      nvec = (total - head) / N;
    }
    const int work = std::max(nvec, total - nvec * N);
    const int blocks = std::min((work + kThreads - 1) / kThreads, sm_count() * kBlocksPerSm);
    tail_flat_kernel<T, kBias><<<blocks, kThreads, 0, stream>>>(
        c2, skip, out, bias, total, head, nvec, c, h * w, channels_last);
    return cudaGetLastError();
  }
  const int ho_n = h / 2, wo_n = w / 2;
  if (channels_last) {
    const int groups = (c + N - 1) / N;
    const bool vec = c % N == 0 && !misalignment(c2) && !misalignment(skip) &&
                     !misalignment(out) && (!kBias || !misalignment(bias));
    const int gx = std::min(groups, kThreads);
    const int gy = std::max(1, std::min(wo_n, 2 * kThreads / gx));
    const dim3 grid((wo_n + gy - 1) / gy, ho_n, n), block(gx, gy);
    if (ho_n > 65535 || n > 65535) return cudaErrorInvalidValue;
    if (vec) {
      tail_pool_cl_kernel<T, kBias, true><<<grid, block, 0, stream>>>(c2, skip, out, bias, c, h,
                                                                      w, groups);
    } else {
      tail_pool_cl_kernel<T, kBias, false><<<grid, block, 0, stream>>>(c2, skip, out, bias, c,
                                                                       h, w, groups);
    }
    return cudaGetLastError();
  }
  const int planes = n * c;
  const int tx = std::min(kThreads, (wo_n + 31) / 32 * 32);
  const dim3 grid(ho_n, std::min(planes, 65535));
  tail_pool_nchw_kernel<T, kBias><<<grid, tx, 0, stream>>>(c2, skip, out, bias, c, h, w, planes);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* c2, const void* skip, void* out, const void* bias, int n, int c, int h,
             int w, int pool, int channels_last, cudaStream_t stream) {
  const T* a = static_cast<const T*>(c2);
  const T* s = static_cast<const T*>(skip);
  const T* b = static_cast<const T*>(bias);
  T* o = static_cast<T*>(out);
  if (bias) return launch<T, true>(a, s, o, b, n, c, h, w, pool, channels_last, stream);
  return launch<T, false>(a, s, o, b, n, c, h, w, pool, channels_last, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`: `c2`, `skip` (n, c, h, w) in one memory format
// (channels_last != 0: NHWC order, else NCHW), f32 (bf16 == 0) or bf16;
// `bias` (c,) of the same type, or null; `out` (n, c, h/2, w/2) with `pool`
// (h and w even), else (n, c, h, w), in the same format. Returns the
// cudaError_t of the launch (0 on success).
int fdtpu_residual_tail(const void* c2, const void* skip, void* out, const void* bias, int bf16,
                        int n, int c, int h, int w, int pool, int channels_last, void* stream) {
  if (n < 0 || c < 1 || h < 0 || w < 0) return cudaErrorInvalidValue;
  if (pool && (h % 2 || w % 2)) return cudaErrorInvalidValue;
  // 32-bit element indices: the inputs must hold fewer than 2^31 elements
  if (static_cast<int64_t>(n) * c * h * w >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(c2, skip, out, bias, n, c, h, w, pool, channels_last, s);
  return dispatch<float>(c2, skip, out, bias, n, c, h, w, pool, channels_last, s);
}

}  // extern "C"
