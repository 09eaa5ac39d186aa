// BatchNorm at eval, the residual add and the activation as one pass, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: fdtpu's XLA fused these elementwise ops into the
// convolution around them, and the port's eager chain after a cuDNN
// convolution (F.batch_norm by the running statistics, then `+ skip`, then
// F.relu or F.leaky_relu) runs two to four passes over the activation, each
// reading what the last one wrote, plus a pass that computes the running
// variance's inverse square root on every call. Launched by
// kernels/bn_act.py's fused_bn_act for each served conv -> BatchNorm
// [-> + skip] [-> activation] chain of RetinaFace (models/layers.bn_act).
//
//   out[m, c] = act(round(round(w_c * (y[m, c] - mean_c) * inv_c + s_c) + skip[m, c]))
//
// on an (N, C, H, W) tensor in channels_last memory, seen as dense rows m
// of C channels (y, skip and out alike). bf16 or f32 activations (the
// Detector serves in either); the BatchNorm's weight, bias, running mean and
// variance as float32, read by address on every launch, so a CUDA graph that
// captured the launch follows changes to them in place.
//
// Exactness against the eager chain (ATen's batch_norm_calc_invstd and
// batch_norm_transform_input_channels_last_kernel, the add and the
// activation, each of which computes in float32 and rounds its result to the
// tensor's type):
//   inv_c = rsqrtf(var_c + eps) (eps as float32),
//   bn    = round(fmaf(w_c * (x - mean_c), inv_c, s_c)): ATen's
//           `w_c * (x - m_c) * inv_std_c + s_c`, whose last multiply and add
//           its build contracts into one FMA (this file builds with
//           -fmad=false, so each op here is the intrinsic that is meant),
//   sum   = round(bn + skip),
//   ReLU: the value or 0 (NaN kept, as clamp_min); LeakyReLU(slope):
//           round(v > 0 ? v : v * slope) with slope as float32.
// round() is to the nearest bf16, the identity in f32. Eager PyTorch runs
// ATen's kernel in bf16; in f32 it picks cuDNN's BatchNorm, whose roundings
// differ from ATen's by an ulp here and there, and the kernel follows ATen's
// (what PyTorch runs in f32 with cuDNN off).
//
// What bounds it on this card: bytes. RetinaFace-R50's 840 px frame moves
// ~0.84 GB through its 73 launches (~0.25 ms at 3.35 TB/s), ~4 flops an
// element. The design:
// - threadIdx.x walks the 16-byte channel groups of a row (8 bf16 or 4 f32
//   channels; blockIdx.x a tile of groups where C is wider than a block),
//   threadIdx.y and blockIdx.y the rows. Each thread loads its group's four
//   per-channel values and computes inv_c once, keeps them in registers, and
//   strides over rows: the grid is one wave of the blocks the SMs hold at
//   once (fewer where a thread would take under kRows rows), and each step
//   keeps kRows independent 16-byte loads of y (and of skip) in flight
//   before it computes and stores them.
// - neighbouring threads sit on neighbouring groups of one row, so each
//   warp's loads and stores are contiguous.
// - a channel count that is not a multiple of the group, or a pointer that
//   is not 16-byte aligned, takes the same kernel with one channel a thread
//   and scalar loads.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread has in flight, and at least takes
constexpr int kMaxDevices = 64;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// L values of T as floats and back; a value already rounded to T packs
// exactly. L is 16 bytes' worth (the vector path) or 1 (the scalar path).
template <typename T, int L>
struct Pack;

template <>
struct Pack<float, 4> {
  using Raw = uint4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                              __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static void unpack(const Raw& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // element 2k is the low half of word k; bf16 -> f32 is a 16-bit shift
  __device__ static void unpack_word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static uint32_t pack_word(const float* f) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[0]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[1]))) << 16);
  }
  __device__ static void unpack(const Raw& u, float* f) {
    unpack_word(u.x, f);
    unpack_word(u.y, f + 2);
    unpack_word(u.z, f + 4);
    unpack_word(u.w, f + 6);
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_word(f), pack_word(f + 2), pack_word(f + 4), pack_word(f + 6));
  }
};

template <>
struct Pack<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void unpack(const Raw& u, float* f) { f[0] = u; }
  __device__ static void store(float* p, const float* f) { *p = f[0]; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void unpack(const Raw& u, float* f) {
    f[0] = __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) { *p = __float2bfloat16_rn(f[0]); }
};

// One element of the chain; w, mean, inv, s: its channel's constants.
template <typename T, bool kSkip, int kAct>
__device__ __forceinline__ float chain(float x, float skip, float w, float mean, float inv,
                                       float s, float slope) {
  float v = round_to(__fmaf_rn(__fmul_rn(w, __fsub_rn(x, mean)), inv, s), T());
  if (kSkip) v = round_to(__fadd_rn(v, skip), T());
  if (kAct == kRelu) v = (v > 0.f || isnan(v)) ? v : 0.f;
  if (kAct == kLeaky) v = round_to(v > 0.f ? v : __fmul_rn(v, slope), T());
  return v;
}

// Thread (x, y) of block (bx, by): channel group g = bx * blockDim.x + x
// (channels g * L .. g * L + L - 1), rows by * blockDim.y + y + k * stride.
template <typename T, int L, bool kSkip, int kAct>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const T* __restrict__ y, const T* __restrict__ skip, T* __restrict__ out,
                  const float* __restrict__ weight, const float* __restrict__ bias,
                  const float* __restrict__ mean, const float* __restrict__ var, float eps,
                  float slope, int rows, int c) {
  using P = Pack<T, L>;
  const int ch0 = (blockIdx.x * blockDim.x + threadIdx.x) * L;
  if (ch0 >= c) return;
  float w[L], m[L], inv[L], s[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    w[l] = __ldg(weight + ch0 + l);
    m[l] = __ldg(mean + ch0 + l);
    inv[l] = rsqrtf(__fadd_rn(__ldg(var + ch0 + l), eps));
    s[l] = __ldg(bias + ch0 + l);
  }
  const int stride = gridDim.y * blockDim.y;
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < rows; row += kRows * stride) {
    typename P::Raw a[kRows], b[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = row + k * stride;
      if (r < rows) {
        a[k] = P::load(y + static_cast<size_t>(r) * c + ch0);
        if (kSkip) b[k] = P::load(skip + static_cast<size_t>(r) * c + ch0);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = row + k * stride;
      if (r >= rows) break;
      float fa[L], fb[L];
      P::unpack(a[k], fa);
      if (kSkip) P::unpack(b[k], fb);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        fa[l] = chain<T, kSkip, kAct>(fa[l], kSkip ? fb[l] : 0.f, w[l], m[l], inv[l], s[l],
                                      slope);
      }
      P::store(out + static_cast<size_t>(r) * c + ch0, fa);
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

// Blocks of kThreads that fit on an SM at once (registers bound it).
template <typename K>
int resident_blocks(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess)
    return 1;
  return std::max(n, 1);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int L, bool kSkip, int kAct>
int launch(const T* y, const T* skip, T* out, const float* weight, const float* bias,
           const float* mean, const float* var, float eps, float slope, int rows, int c,
           cudaStream_t stream) {
  const int groups = c / L;
  const int gx = std::min(groups, kThreads);
  const int gy = std::max(1, kThreads / gx);
  const int tiles = (groups + gx - 1) / gx;
  // one wave: as many blocks as the SMs hold at once, each thread then
  // striding over its rows (read once per instantiation, at its first
  // launch, which is eager: a CUDA graph is captured after a warm-up)
  static const int resident = resident_blocks(bn_act_kernel<T, L, kSkip, kAct>);
  const int fill = std::max(1, sm_count() * resident / tiles);
  const int by = std::min({(rows + gy * kRows - 1) / (gy * kRows), fill, 65535});
  bn_act_kernel<T, L, kSkip, kAct><<<dim3(tiles, by), dim3(gx, gy), 0, stream>>>(
      y, skip, out, weight, bias, mean, var, eps, slope, rows, c);
  return cudaGetLastError();
}

template <typename T, int L, bool kSkip>
int by_act(int act, const T* y, const T* skip, T* out, const float* weight, const float* bias,
           const float* mean, const float* var, float eps, float slope, int rows, int c,
           cudaStream_t stream) {
  switch (act) {
    case kNone:
      return launch<T, L, kSkip, kNone>(y, skip, out, weight, bias, mean, var, eps, slope, rows,
                                        c, stream);
    case kRelu:
      return launch<T, L, kSkip, kRelu>(y, skip, out, weight, bias, mean, var, eps, slope, rows,
                                        c, stream);
    case kLeaky:
      return launch<T, L, kSkip, kLeaky>(y, skip, out, weight, bias, mean, var, eps, slope,
                                         rows, c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* y, const void* skip, void* out, const float* weight, const float* bias,
             const float* mean, const float* var, float eps, int act, float slope, int rows,
             int c, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const T* a = static_cast<const T*>(y);
  const T* b = static_cast<const T*>(skip);
  T* o = static_cast<T*>(out);
  const bool vec = c % N == 0 && aligned16(y) && aligned16(out) && (!skip || aligned16(skip));
  if (vec && skip)
    return by_act<T, N, true>(act, a, b, o, weight, bias, mean, var, eps, slope, rows, c,
                              stream);
  if (vec)
    return by_act<T, N, false>(act, a, b, o, weight, bias, mean, var, eps, slope, rows, c,
                               stream);
  if (skip)
    return by_act<T, 1, true>(act, a, b, o, weight, bias, mean, var, eps, slope, rows, c,
                              stream);
  return by_act<T, 1, false>(act, a, b, o, weight, bias, mean, var, eps, slope, rows, c,
                             stream);
}

}  // namespace

extern "C" {

// Launch on `stream`: `y`, `skip` (or null) and `out` `rows` x `c` dense
// (channels_last (N, C, H, W) with rows = N H W), all bf16 (bf16 != 0) or
// f32; `weight`, `bias`, `mean`, `var` (c,) float32; `act` 0 none, 1 ReLU,
// 2 LeakyReLU with `slope`. Returns the cudaError_t of the launch (0 on success).
int fdtpu_bn_act(const void* y, const void* skip, void* out, const float* weight,
                 const float* bias, const float* mean, const float* var, float eps, int act,
                 float slope, int bf16, int rows, int c, void* stream) {
  if (rows < 0 || c < 1 || act < kNone || act > kLeaky) return cudaErrorInvalidValue;
  // 32-bit row and channel indices; offsets are computed in 64 bits
  if (static_cast<int64_t>(rows) * c >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(y, skip, out, weight, bias, mean, var, eps, act, slope, rows,
                                   c, s);
  return dispatch<float>(y, skip, out, weight, bias, mean, var, eps, act, slope, rows, c, s);
}

}  // extern "C"
