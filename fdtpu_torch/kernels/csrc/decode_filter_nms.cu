// Fused decode + confidence filter + greedy NMS, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/nms_pallas.py:_batched_nms_kernel (the whole-batch
// TPU kernel) and, at B = 1, nms_pallas.py:_nms_kernel. Same semantics:
//   * decode pixel = value * scale + offset from per-row tables, xyxy
//     corners rounded half to even (rintf, as jnp.round / torch.round);
//   * alive iff conf > prob_thr (strict);
//   * `capacity` greedy rounds: argmax over (score, index) with the lowest
//     index winning ties, emit [score, x0, y0, x1 - x0, y1 - y0], kill every
//     alive candidate whose IoU with the pick is > iou_thr; stop early once
//     nothing is alive. All candidates are scanned (no top-k truncation).
//
// What bounds it on this card: latency, not bytes. One image is B x N x 20
// bytes of input (4.5 KB at N = 225), read once; the cost is `capacity`
// serial rounds, each a block-wide argmax reduction plus a suppression pass,
// and each round waits on the one before it.
// What the design does about it: one CTA per image, so a batch runs its
// images' rounds side by side on the card's 132 SMs; the decoded planes live
// in shared memory, so a round touches no device memory; each round costs
// two barriers (a warp-shuffle argmax, one shared step across the 8 warps
// that every thread finishes on its own, and the __syncthreads_or that also
// ends the loop early). Faster shapes (a warp per image at grid scale,
// several images per CTA, CUDA graphs) are later work.
//
// Exactness against the plain PyTorch version and fdtpu's kernel: every
// multiply, add and divide is a round-to-nearest intrinsic, so nothing is
// contracted into an FMA (the build also passes -fmad=false), and the IoU
// division is IEEE. Max-with-zero propagates NaN as XLA and torch do.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// per candidate: x0, y0, x1, y1, area, conf as float, then an alive byte
constexpr int kFloatPlanes = 6;
constexpr int kBytesPerCandidate = kFloatPlanes * sizeof(float) + 1;

__device__ __forceinline__ float max0(float d) { return d < 0.f ? 0.f : d; }

// Total order of the argmax: higher score first, then lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads) decode_filter_nms_kernel(
    const float* __restrict__ values,  // (B, N, 5) [conf, x, y, w, h]
    const float* __restrict__ sx, const float* __restrict__ ox,
    const float* __restrict__ sy, const float* __restrict__ oy,  // (N,) each
    float w_scale, float h_scale, float prob_thr, float iou_thr, int n,
    int capacity,
    float* __restrict__ boxes,           // (B, capacity, 5), zero-filled
    unsigned char* __restrict__ mask) {  // (B, capacity), zero-filled
  extern __shared__ float planes[];
  float* x0s = planes;
  float* y0s = x0s + n;
  float* x1s = y0s + n;
  float* y1s = x1s + n;
  float* areas = y1s + n;
  float* confs = areas + n;
  unsigned char* alive = reinterpret_cast<unsigned char*>(confs + n);
  __shared__ float warp_score[kWarps];
  __shared__ int warp_index[kWarps];

  const int tid = threadIdx.x;
  const float* v = values + static_cast<size_t>(blockIdx.x) * n * 5;
  float* out = boxes + static_cast<size_t>(blockIdx.x) * capacity * 5;
  unsigned char* out_mask = mask + static_cast<size_t>(blockIdx.x) * capacity;

  // Decode this thread's candidates into shared memory. Each thread owns the
  // candidates i = tid (mod kThreads) and is the only one to read or write
  // their alive flags; the coordinates are read by every thread.
  int any_alive = 0;
  for (int i = tid; i < n; i += kThreads) {
    const float* r = v + static_cast<size_t>(i) * 5;
    const float x = __fadd_rn(__fmul_rn(r[1], sx[i]), ox[i]);
    const float y = __fadd_rn(__fmul_rn(r[2], sy[i]), oy[i]);
    const float w = __fmul_rn(r[3], w_scale);
    const float h = __fmul_rn(r[4], h_scale);
    const float x0 = rintf(x), y0 = rintf(y);
    const float x1 = rintf(__fadd_rn(x, w)), y1 = rintf(__fadd_rn(y, h));
    x0s[i] = x0;
    y0s[i] = y0;
    x1s[i] = x1;
    y1s[i] = y1;
    areas[i] = __fmul_rn(max0(__fsub_rn(x1, x0)), max0(__fsub_rn(y1, y0)));
    const float c = r[0];
    confs[i] = c;
    const unsigned char a = c > prob_thr;
    alive[i] = a;
    any_alive |= a;
  }
  // The barrier also publishes the planes to every thread.
  if (!__syncthreads_or(any_alive)) return;

  const int lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < capacity; ++k) {
    // Masked argmax: a dead candidate scores -1, as in the Pallas kernel.
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float s = alive[i] ? confs[i] : -1.f;
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_score[warp] = bs;
      warp_index[warp] = bi;
    }
    __syncthreads();
    bs = warp_score[0];
    bi = warp_index[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(warp_score[w], warp_index[w], bs, bi)) {
        bs = warp_score[w];
        bi = warp_index[w];
      }
    }
    // Block-uniform: with no valid pick every later row stays zero.
    if (!(bs > -0.5f)) break;

    const float px0 = x0s[bi], py0 = y0s[bi], px1 = x1s[bi], py1 = y1s[bi];
    const float parea = areas[bi];
    if (tid == 0) {
      float* row = out + static_cast<size_t>(k) * 5;
      row[0] = bs;
      row[1] = px0;
      row[2] = py0;
      row[3] = __fsub_rn(px1, px0);
      row[4] = __fsub_rn(py1, py0);
      out_mask[k] = 1;
    }

    int survivors = 0;
    for (int i = tid; i < n; i += kThreads) {
      if (!alive[i]) continue;
      if (i == bi) {
        alive[i] = 0;
        continue;
      }
      const float ix0 = fmaxf(x0s[i], px0), iy0 = fmaxf(y0s[i], py0);
      const float ix1 = fminf(x1s[i], px1), iy1 = fminf(y1s[i], py1);
      const float inter =
          __fmul_rn(max0(__fsub_rn(ix1, ix0)), max0(__fsub_rn(iy1, iy0)));
      const float uni = __fsub_rn(__fadd_rn(areas[i], parea), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      if (iou <= iou_thr) {
        survivors = 1;
      } else {
        alive[i] = 0;
      }
    }
    // Also orders this round's reads of warp_score before the next writes.
    if (!__syncthreads_or(survivors)) break;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: one CTA per image. Returns the
// cudaError_t of the launch (0 on success). Outputs must be zero-filled.
int fdtpu_decode_filter_nms(const void* values, const void* sx, const void* ox,
                            const void* sy, const void* oy, float w_scale,
                            float h_scale, float prob_thr, float iou_thr,
                            int batch, int n, int capacity, void* boxes,
                            void* mask, void* stream) {
  const size_t smem = static_cast<size_t>(n) * kBytesPerCandidate;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_filter_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_filter_nms_kernel<<<batch, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(sx),
      static_cast<const float*>(ox), static_cast<const float*>(sy),
      static_cast<const float*>(oy), w_scale, h_scale, prob_thr, iou_thr, n,
      capacity, static_cast<float*>(boxes),
      static_cast<unsigned char*>(mask));
  return cudaGetLastError();
}

// The largest candidate count whose planes fit one CTA's shared memory on
// `device`, written to *out.
int fdtpu_decode_filter_nms_max_candidates(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, decode_filter_nms_kernel);
  if (err != cudaSuccess) return err;
  *out = (optin - static_cast<int>(attr.sharedSizeBytes)) / kBytesPerCandidate;
  return cudaSuccess;
}

const char* fdtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
