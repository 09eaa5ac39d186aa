// The three passes of the three-shear rotation, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/rotate_pallas.py:_shear_x_kernel (K3a, passes 1 and
// 3 of rotate_batch), :_shear_y_kernel (K3b, pass 2) and :_shear_kernel (K4,
// every pass of the superseded rotate_batch_transposed layout, which is
// shear_rows with c = 1 and row_mod = the block period). Same semantics, on
// (planes, rows, lanes) arrays whose lane axis interleaves `c` channels
// (lane = x * c + ch):
//   shear_rows: t = k * ((row mod row_mod) - center), n = floor(t),
//               f = t - n, out(r, l) = (1 - f) * in(r, l + n c)
//                                     + f * in(r, l + (n + 1) c);
//   shear_cols: t = k * ((l / c) - center), the same along rows:
//               out(r, l) = (1 - f) * in(r + n, l) + f * in(r + n + 1, l).
// A tap outside the plane reads 0. The TPU kernels roll instead, and wrap;
// either way such taps land only in the reflect margin that rotate_batch
// crops away.
//
// Exactness against the plain PyTorch version: the TPU kernel sums
// acc += c_j * s_j over its roll slices, and only two weights are non-zero,
// so it computes fl(fl((1 - f) * a) + fl(f * b)). Every multiply, add and
// subtract here is a round-to-nearest intrinsic (the build also passes
// -fmad=false), so nothing is contracted into an FMA; loads widen to f32
// exactly and stores round to the plane type to nearest even.
//
// What bounds it on this card: bytes. Each output element reads two inputs
// and writes one, with 8 flops; at 26 x 768 x 2304 bf16 planes a pass moves
// ~0.3 GB. What the design does about it: one CTA per plane row, threads
// striding along lanes, so loads and stores are coalesced (the two taps of
// neighbouring lanes are neighbours too) and each row computes its shear
// once. Tiling a band in shared memory, vector loads and fusing the three
// passes are later work.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// (1 - f) * a + f * b, each product and the sum rounded once.
__device__ __forceinline__ float blend(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_rows_kernel(const T* __restrict__ in, T* __restrict__ out,
                      const float* __restrict__ k, int rows, int lanes, int c,
                      int row_mod, float center) {
  const int row = blockIdx.x;  // plane * rows + r
  const int plane = row / rows;
  int r = row - plane * rows;
  if (row_mod > 0) r %= row_mod;
  const float t =
      __fmul_rn(k[plane], __fsub_rn(static_cast<float>(r), center));
  const float n = floorf(t);
  const float f = __fsub_rn(t, n);
  const int shift = static_cast<int>(n) * c;
  const size_t base = static_cast<size_t>(row) * lanes;
  const T* src = in + base;
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    const int j0 = l + shift, j1 = j0 + c;
    const float a = (j0 >= 0 && j0 < lanes) ? load(src + j0) : 0.f;
    const float b = (j1 >= 0 && j1 < lanes) ? load(src + j1) : 0.f;
    store(out + base + l, blend(a, b, f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_cols_kernel(const T* __restrict__ in, T* __restrict__ out,
                      const float* __restrict__ k, int rows, int lanes, int c,
                      float center) {
  const int row = blockIdx.x;
  const int plane = row / rows;
  const int r = row - plane * rows;
  const float kp = k[plane];
  const T* src = in + static_cast<size_t>(plane) * rows * lanes;
  T* dst = out + static_cast<size_t>(row) * lanes;
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    const float t = __fmul_rn(kp, __fsub_rn(static_cast<float>(l / c), center));
    const float n = floorf(t);
    const float f = __fsub_rn(t, n);
    const int r0 = r + static_cast<int>(n), r1 = r0 + 1;
    const float a =
        (r0 >= 0 && r0 < rows) ? load(src + static_cast<size_t>(r0) * lanes + l) : 0.f;
    const float b =
        (r1 >= 0 && r1 < rows) ? load(src + static_cast<size_t>(r1) * lanes + l) : 0.f;
    store(dst + l, blend(a, b, f));
  }
}

}  // namespace

extern "C" {

// Launch on `stream`, one CTA per plane row. `in`, `out`: (planes, rows,
// lanes) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); `k`: (planes,) f32
// on the card. Returns the cudaError_t of the launch (0 on success).
int fdtpu_shear_rows(const void* in, void* out, const void* k, int bf16,
                     int planes, int rows, int lanes, int c, int row_mod,
                     float center, void* stream) {
  const dim3 grid(static_cast<unsigned>(planes) * static_cast<unsigned>(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  if (bf16) {
    shear_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out),
        kk, rows, lanes, c, row_mod, center);
  } else {
    shear_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), kk, rows,
        lanes, c, row_mod, center);
  }
  return cudaGetLastError();
}

int fdtpu_shear_cols(const void* in, void* out, const void* k, int bf16,
                     int planes, int rows, int lanes, int c, float center,
                     void* stream) {
  const dim3 grid(static_cast<unsigned>(planes) * static_cast<unsigned>(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  if (bf16) {
    shear_cols_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out),
        kk, rows, lanes, c, center);
  } else {
    shear_cols_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), kk, rows,
        lanes, c, center);
  }
  return cudaGetLastError();
}

}  // extern "C"
