// The fused residual-block tail, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/epilogue_pallas.py:_tail_kernel (K6, launched by
// fused_residual_tail): out = maxpool2x2(leaky(c2, 0.2) + skip), or the same
// without the pool, on (N, C, H, W) tensors in channels_last or contiguous
// NCHW memory, float32 or bfloat16.
//
// Exactness against the plain PyTorch version (the port's eager tail:
// F.leaky_relu, +, F.max_pool2d): each of the three eager ops computes in
// float32 and rounds its result to the tensor's type, so here
//   y = round(x > 0 ? x : x * 0.2f), y = round(float(y) + float(skip)),
// then the 2x2 window's max, scanned row by row from -inf, where a later
// value replaces the max only when it is greater or NaN (max_pool2d's rule).
// The multiply and add are round-to-nearest intrinsics under -fmad=false.
// fdtpu's bf16 kernel multiplies by 0.2 rounded to bf16 instead, so the port
// may differ from fdtpu by one bf16 step on negative inputs; it is held to
// its own eager tail.
//
// What bounds it on this card: bytes. A pooled 40x40 -> 20x20 block at b128,
// 128 channels, bf16 reads 105 MB and writes 13 MB, ~3 flops an input; the
// eager tail moves each intermediate through memory three times more. What
// the design does about it: one pass, one thread per output element in the
// output's memory order, so with channels_last (channels innermost)
// neighbouring threads read and write neighbouring addresses. Vector loads
// of several channels a thread and folding the conv bias in are later work.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// leaky(c2) + skip, each op rounded to T as the eager ops round.
template <typename T>
__device__ __forceinline__ float tail(const T* c2, const T* skip, size_t off) {
  const float x = load(c2 + off);
  const float y = round_to(x > 0.f ? x : __fmul_rn(x, 0.2f), T());
  return round_to(__fadd_rn(y, load(skip + off)), T());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_tail_kernel(const T* __restrict__ c2, const T* __restrict__ skip,
                         T* __restrict__ out, int c, int h, int w, int pool,
                         int channels_last, int total) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;  // total < 2^31
  if (idx >= total) return;
  const int ho_n = pool ? h / 2 : h, wo_n = pool ? w / 2 : w;
  int t = idx, n, ch, ho, wo;
  size_t sc, sh, sw;
  if (channels_last) {  // memory order (n, h, w, c)
    ch = t % c;
    t /= c;
    wo = t % wo_n;
    t /= wo_n;
    ho = t % ho_n;
    n = t / ho_n;
    sc = 1;
    sw = c;
    sh = static_cast<size_t>(w) * c;
  } else {  // memory order (n, c, h, w)
    wo = t % wo_n;
    t /= wo_n;
    ho = t % ho_n;
    t /= ho_n;
    ch = t % c;
    n = t / c;
    sc = static_cast<size_t>(h) * w;
    sw = 1;
    sh = w;
  }
  const size_t base = static_cast<size_t>(n) * c * h * w + ch * sc;
  if (!pool) {
    store(out + idx, tail(c2, skip, base + ho * sh + wo * sw));
    return;
  }
  float m = -INFINITY;
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const float v = tail(c2, skip, base + (2 * ho + dy) * sh + (2 * wo + dx) * sw);
      if (v > m || isnan(v)) m = v;
    }
  }
  store(out + idx, m);
}

template <typename T>
int launch(const void* c2, const void* skip, void* out, int n, int c, int h, int w, int pool,
           int channels_last, cudaStream_t stream) {
  // 32-bit element indices: the inputs must hold fewer than 2^31 elements
  if (static_cast<int64_t>(n) * c * h * w >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int total = n * c * (pool ? h / 2 : h) * (pool ? w / 2 : w);
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (static_cast<unsigned>(total) + kThreads - 1) / kThreads;
  residual_tail_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(c2), static_cast<const T*>(skip), static_cast<T*>(out), c, h, w,
      pool, channels_last, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: `c2`, `skip` (n, c, h, w) in one memory format
// (channels_last != 0: NHWC order, else NCHW), f32 (bf16 == 0) or bf16;
// `out` (n, c, h/2, w/2) with `pool` (h and w even), else (n, c, h, w), in
// the same format. Returns the cudaError_t of the launch (0 on success).
int fdtpu_residual_tail(const void* c2, const void* skip, void* out, int bf16, int n, int c,
                        int h, int w, int pool, int channels_last, void* stream) {
  if (pool && (h % 2 || w % 2)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(c2, skip, out, n, c, h, w, pool, channels_last, s);
  }
  return launch<float>(c2, skip, out, n, c, h, w, pool, channels_last, s);
}

}  // extern "C"
