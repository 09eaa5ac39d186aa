// Fused decode + confidence filter + greedy NMS, for NVIDIA Hopper (sm_90a).
//
// Replaces fdtpu/kernels/nms_pallas.py:_batched_nms_kernel (the whole-batch
// TPU kernel) and, at B = 1, nms_pallas.py:_nms_kernel. Same semantics:
//   * decode pixel = value * scale + offset from per-row tables, xyxy
//     corners rounded half to even (rintf, as jnp.round / torch.round);
//   * alive iff conf > prob_thr (strict);
//   * `capacity` greedy rounds: argmax over (score, index) with the lowest
//     index winning ties, emit [score, x0, y0, x1 - x0, y1 - y0], kill every
//     alive candidate whose IoU with the pick is > iou_thr (precisely: not
//     <= iou_thr); stop once the best alive score is not > -0.5 (a dead
//     candidate scores -1) or nothing is alive. All candidates are scanned
//     (no top-k truncation); rows after the last valid one are zero.
//
// What bounds it on this card: latency, not bytes. One image is N x 20
// bytes of input (4.5 KB at N = 225), read once; the greedy loop is a chain
// of `capacity` dependent rounds, and done literally each round costs a
// block-wide argmax, a suppression pass over N and two barriers (~1 us a
// round on this card).
// What the design does about it: the greedy loop is the same as "sort the
// alive candidates by (score desc, index asc), then keep each one that no
// kept earlier one suppresses", since the IoU as computed here is symmetric
// in its two boxes (fmaxf, fminf and the area sum commute). So one CTA per
// image
//   1. decodes its candidates into shared planes (16-byte loads of four
//      rows a thread where the image's rows start on the 16-byte grid) and
//      appends the eligible ones (conf > prob_thr and conf > -0.5: the scan
//      ends at the first score <= -0.5, as the greedy loop does) to a list
//      with one warp-aggregated atomic a warp;
//   2. sorts the list in shared memory: by rank counting when it fits one
//      candidate a thread (M <= 256, one barrier), else by a bitonic sort of
//      pow2(M) slots. Scores compare as floats, so +0.0 and -0.0 tie and the
//      index decides, as in the argmax;
//   3. resolves the sorted list in chunks of 32: every thread tests the
//      chunk against the boxes kept so far (at most `capacity`) and the
//      chunk's 32 x 32 triangle, each row a __ballot_sync word; then one
//      warp resolves the chunk in registers, a ballot a round over the
//      rule "kept iff no kept earlier row suppresses it" until a round
//      changes nothing, no barrier, and appends its kept indices in place
//      at the front of the list. It stops at `capacity` kept or the end of
//      the list;
//   4. writes every output row, the zero rows after the last kept one
//      included, so the caller allocates the outputs uninitialised; given
//      an index output, each kept row's candidate index there too, -1 past
//      the kept rows (a null index pointer writes nothing).
// That is ~M/32 chunks of two barriers each in place of `capacity` rounds
// of two (M ~ 112 at b128 on random maps: 4 chunks against 64 rounds).
//
// Any N: the planes and the list of an image live in the CTA's shared
// memory while they fit (N <= max_candidates, 8,186 on the H100). Above
// that the same kernel runs on a slice of global scratch per image, which
// the caller allocates (fdtpu_decode_filter_nms_scratch_floats floats an
// image): the same algorithm and arithmetic, every step bit for bit, only
// with the planes and the bitonic sort in device memory (L1/L2) instead of
// shared memory. __syncthreads orders the block's global accesses as it
// does its shared ones. fdtpu's kernel takes any N as well, by tiling the
// batch and keeping N whole (nms_pallas.py:262-274).
//
// Exactness against the plain PyTorch version and fdtpu's kernel: every
// multiply, add and divide is a round-to-nearest intrinsic, so nothing is
// contracted into an FMA (the build also passes -fmad=false), and the IoU
// division is IEEE. The IoU keeps the greedy kernel's operand order (the
// later candidate first, the kept one second). Max-with-zero propagates NaN
// as XLA and torch do. Each emitted row is the kept candidate's own conf
// and corners.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// per candidate: x0, y0, x1, y1, area, conf as float
constexpr int kFloatPlanes = 6;

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One image's working set in floats (4 bytes each) for `n` candidates: the
// planes, then the list of eligible indices, pow2(n) slots for the bitonic
// sort. Dynamic shared memory, or a slice of the global scratch.
__host__ __device__ __forceinline__ size_t work_floats(int n) {
  return static_cast<size_t>(n) * kFloatPlanes + static_cast<size_t>(pow2_at_least(n));
}

__device__ __forceinline__ float max0(float d) { return d < 0.f ? 0.f : d; }

// The greedy order: higher score first, then lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

struct Planes {
  float *x0, *y0, *x1, *y1, *area, *conf;

  // Does kept box p suppress candidate i? The greedy kernel's test of i
  // against the pick p: killed unless IoU <= thr.
  __device__ __forceinline__ bool suppresses(int p, int i, float thr) const {
    const float ix0 = fmaxf(x0[i], x0[p]), iy0 = fmaxf(y0[i], y0[p]);
    const float ix1 = fminf(x1[i], x1[p]), iy1 = fminf(y1[i], y1[p]);
    const float inter = __fmul_rn(max0(__fsub_rn(ix1, ix0)), max0(__fsub_rn(iy1, iy0)));
    const float uni = __fsub_rn(__fadd_rn(area[i], area[p]), inter);
    const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
    return !(iou <= thr);
  }
};

__global__ void __launch_bounds__(kThreads) decode_filter_nms_kernel(
    const float* __restrict__ values,  // (B, N, 5) [conf, x, y, w, h]
    const float* __restrict__ sx, const float* __restrict__ ox,
    const float* __restrict__ sy, const float* __restrict__ oy,  // (N,) each
    float w_scale, float h_scale, float prob_thr, float iou_thr, int n,
    int capacity,
    float* __restrict__ boxes,           // (B, capacity, 5), every row written
    unsigned char* __restrict__ mask,    // (B, capacity), every entry written
    int* __restrict__ index,             // null, or (B, capacity), every entry written
    float* scratch) {  // null: the working set in shared memory; else
                       // (B, work_floats(n)) in device memory
  extern __shared__ float smem[];
  float* work = scratch ? scratch + blockIdx.x * work_floats(n) : smem;
  const Planes pl{work, work + n, work + 2 * n, work + 3 * n, work + 4 * n, work + 5 * n};
  int* list = reinterpret_cast<int*>(work + kFloatPlanes * n);
  __shared__ int s_count;                 // eligible candidates M, then kept
  __shared__ unsigned s_by_kept;          // chunk rows suppressed by a kept box
  __shared__ unsigned s_tri[32];          // chunk row q: earlier rows suppressing q
  __shared__ float s_key[kThreads];       // rank sort: scores and indices
  __shared__ int s_idx[kThreads];
  __shared__ int s_sorted[kThreads];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* v = values + static_cast<size_t>(blockIdx.x) * n * 5;
  float* out = boxes + static_cast<size_t>(blockIdx.x) * capacity * 5;
  unsigned char* out_mask = mask + static_cast<size_t>(blockIdx.x) * capacity;
  if (tid == 0) {
    s_count = 0;
    s_by_kept = 0;
  }
  __syncthreads();

  // 1. Decode into the planes; append the eligible to the list, one atomic
  // a warp. Called by every lane of a warp together.
  auto decode = [&](int i, bool in, float c, float vx, float vy, float vw, float vh) {
    bool eligible = false;
    if (in) {
      const float x = __fadd_rn(__fmul_rn(vx, sx[i]), ox[i]);
      const float y = __fadd_rn(__fmul_rn(vy, sy[i]), oy[i]);
      const float w = __fmul_rn(vw, w_scale);
      const float h = __fmul_rn(vh, h_scale);
      const float x0 = rintf(x), y0 = rintf(y);
      const float x1 = rintf(__fadd_rn(x, w)), y1 = rintf(__fadd_rn(y, h));
      pl.x0[i] = x0;
      pl.y0[i] = y0;
      pl.x1[i] = x1;
      pl.y1[i] = y1;
      pl.area[i] = __fmul_rn(max0(__fsub_rn(x1, x0)), max0(__fsub_rn(y1, y0)));
      pl.conf[i] = c;
      eligible = c > prob_thr && c > -0.5f;
    }
    const unsigned ballot = __ballot_sync(kFull, eligible);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
    base = __shfl_sync(kFull, base, 0);
    if (eligible) list[base + __popc(ballot & ((1u << lane) - 1))] = i;
  };
  if (reinterpret_cast<uintptr_t>(v) % 16 == 0) {
    // four rows (20 floats) a thread as five 16-byte loads
    const int groups = (n + 3) / 4;
    for (int g0 = 0; g0 < groups; g0 += kThreads) {
      const int g = g0 + tid;
      float r[20];
      if (g < groups && 4 * g + 3 < n) {
        const float4* p = reinterpret_cast<const float4*>(v + 20 * g);
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const float4 u = p[q];
          r[4 * q] = u.x;
          r[4 * q + 1] = u.y;
          r[4 * q + 2] = u.z;
          r[4 * q + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 20; ++q) r[q] = (g < groups && 5 * (4 * g) + q < 5 * n) ? v[20 * g + q] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * g + j;
        decode(i, g < groups && i < n, r[5 * j], r[5 * j + 1], r[5 * j + 2], r[5 * j + 3],
               r[5 * j + 4]);
      }
    }
  } else {
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const bool in = i < n;
      const float* r = v + static_cast<size_t>(in ? i : 0) * 5;
      decode(i, in, in ? r[0] : 0.f, in ? r[1] : 0.f, in ? r[2] : 0.f, in ? r[3] : 0.f,
             in ? r[4] : 0.f);
    }
  }
  __syncthreads();
  const int m = s_count;

  // 2. Sort the list by (score desc, index asc).
  int* sorted = list;
  if (m > 0 && m <= kThreads) {
    if (tid < m) {
      const int i = list[tid];
      s_idx[tid] = i;
      s_key[tid] = pl.conf[i];
    }
    __syncthreads();
    if (tid < m) {
      const int i = s_idx[tid];
      const float s = s_key[tid];
      int rank = 0;
      for (int j = 0; j < m; ++j) rank += better(s_key[j], s_idx[j], s, i);
      s_sorted[rank] = i;
    }
    sorted = s_sorted;
    __syncthreads();
  } else if (m > kThreads) {
    const int p2 = pow2_at_least(m);
    for (int i = m + tid; i < p2; i += kThreads) list[i] = INT_MAX;  // sorts last
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < p2 / 2; t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const int a = list[lo], b = list[hi];
          // b before a / a before b in the greedy order (padding last)
          const bool b_first = a == INT_MAX ? b != INT_MAX
                                            : b != INT_MAX && better(pl.conf[b], b, pl.conf[a], a);
          const bool a_first = b == INT_MAX ? a != INT_MAX
                                            : a != INT_MAX && better(pl.conf[a], a, pl.conf[b], b);
          if ((lo & size) ? a_first : b_first) {
            list[lo] = b;
            list[hi] = a;
          }
        }
        __syncthreads();
      }
    }
  }

  // 3. Resolve in chunks of 32; the kept indices go to sorted[0, kept).
  int kept = 0;
  for (int c0 = 0; c0 < m && kept < capacity; c0 += 32) {
    const int len = min(32, m - c0);
    const bool in = lane < len;
    const int qi = in ? sorted[c0 + lane] : 0;
    // the chunk against every kept box: warp w takes kept w, w + 8, ...
    bool hit = false;
    if (in) {
      for (int p = warp; p < kept && !hit; p += kWarps) hit = pl.suppresses(sorted[p], qi, iou_thr);
    }
    const unsigned hits = __ballot_sync(kFull, hit);
    if (lane == 0 && hits) atomicOr(&s_by_kept, hits);
    // the chunk's triangle: row q's word holds the earlier rows that
    // suppress it
    for (int q = warp; q < len; q += kWarps) {
      const int qq = __shfl_sync(kFull, qi, q);
      const unsigned word = __ballot_sync(kFull, lane < q && pl.suppresses(qi, qq, iou_thr));
      if (lane == 0) s_tri[q] = word;
    }
    __syncthreads();
    if (warp == 0) {
      // Row q is kept iff no kept box and no kept earlier row suppresses it.
      // That rule has one solution (row 0 is decided alone, row q by the
      // rows before it), the greedy one; iterating it from "every row the
      // kept boxes spare" settles on it after at most the longest chain of
      // suppressions, one ballot a round, and any round that changes
      // nothing has reached it.
      const unsigned by = in ? s_tri[lane] : 0u;
      const unsigned spared = ~s_by_kept & (len == 32 ? kFull : (1u << len) - 1);
      const bool alive = (spared >> lane) & 1u;
      unsigned keep = spared;
      for (;;) {
        const unsigned next = __ballot_sync(kFull, alive && !(by & keep));
        if (next == keep) break;
        keep = next;
      }
      // the first capacity - kept of them, appended in order
      const unsigned below = keep & ((1u << lane) - 1);
      const int rank = __popc(below);
      const bool take = ((keep >> lane) & 1u) && kept + rank < capacity;
      if (take) sorted[kept + rank] = qi;
      const int taken = __popc(__ballot_sync(kFull, take));
      if (lane == 0) {
        s_count = kept + taken;
        s_by_kept = 0;
      }
    }
    __syncthreads();
    kept = s_count;
  }

  // 4. Every output row: the kept boxes, then zeros.
  for (int j = tid; j < capacity * 5; j += kThreads) {
    const int k = j / 5, col = j - 5 * k;
    float val = 0.f;
    if (k < kept) {
      const int i = sorted[k];
      val = col == 0   ? pl.conf[i]
            : col == 1 ? pl.x0[i]
            : col == 2 ? pl.y0[i]
            : col == 3 ? __fsub_rn(pl.x1[i], pl.x0[i])
                       : __fsub_rn(pl.y1[i], pl.y0[i]);
    }
    out[j] = val;
  }
  for (int j = tid; j < capacity; j += kThreads) out_mask[j] = j < kept;
  if (index) {
    int* out_index = index + static_cast<size_t>(blockIdx.x) * capacity;
    for (int j = tid; j < capacity; j += kThreads) out_index[j] = j < kept ? sorted[j] : -1;
  }
}

}  // namespace

extern "C" {

namespace {

int launch(const void* values, const void* sx, const void* ox, const void* sy,
           const void* oy, float w_scale, float h_scale, float prob_thr,
           float iou_thr, int batch, int n, int capacity, void* boxes,
           void* mask, void* index, void* scratch, void* stream) {
  const size_t smem = scratch ? 0 : work_floats(n) * sizeof(float);
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
      capacity, static_cast<float*>(boxes), static_cast<unsigned char*>(mask),
      static_cast<int*>(index), static_cast<float*>(scratch));
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` with each image's working set in shared
// memory: one CTA per image, n <= max_candidates. Returns the cudaError_t
// of the launch (0 on success). The kernel writes every entry of both
// outputs.
int fdtpu_decode_filter_nms(const void* values, const void* sx, const void* ox,
                            const void* sy, const void* oy, float w_scale,
                            float h_scale, float prob_thr, float iou_thr,
                            int batch, int n, int capacity, void* boxes,
                            void* mask, void* stream) {
  return launch(values, sx, ox, sy, oy, w_scale, h_scale, prob_thr, iou_thr,
                batch, n, capacity, boxes, mask, nullptr, nullptr, stream);
}

// The same, with each image's working set in `scratch`: device memory of
// batch * fdtpu_decode_filter_nms_scratch_floats(n) floats, any content,
// which the kernel overwrites. Any n >= 1.
int fdtpu_decode_filter_nms_scratch(const void* values, const void* sx,
                                    const void* ox, const void* sy,
                                    const void* oy, float w_scale,
                                    float h_scale, float prob_thr,
                                    float iou_thr, int batch, int n,
                                    int capacity, void* boxes, void* mask,
                                    void* scratch, void* stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch(values, sx, ox, sy, oy, w_scale, h_scale, prob_thr, iou_thr,
                batch, n, capacity, boxes, mask, nullptr, scratch, stream);
}

// Either of the two above, which also writes each kept row's candidate
// index to `index`, (batch, capacity) int32, -1 past the kept rows: the
// working set in `scratch` where it is not null, else in shared memory
// (n <= max_candidates).
int fdtpu_decode_filter_nms_indexed(const void* values, const void* sx,
                                    const void* ox, const void* sy,
                                    const void* oy, float w_scale,
                                    float h_scale, float prob_thr,
                                    float iou_thr, int batch, int n,
                                    int capacity, void* boxes, void* mask,
                                    void* index, void* scratch, void* stream) {
  if (index == nullptr) return cudaErrorInvalidValue;
  return launch(values, sx, ox, sy, oy, w_scale, h_scale, prob_thr, iou_thr,
                batch, n, capacity, boxes, mask, index, scratch, stream);
}

// Floats of scratch one image takes at `n` candidates.
long long fdtpu_decode_filter_nms_scratch_floats(int n) {
  return static_cast<long long>(work_floats(n));
}

// The largest candidate count whose planes and list fit one CTA's shared
// memory on `device`, written to *out.
int fdtpu_decode_filter_nms_max_candidates(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, decode_filter_nms_kernel);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  // for each list size p2, the most candidates n <= p2 whose planes fit
  size_t best = 0;
  for (size_t p2 = 1; p2 * sizeof(int) <= budget && p2 <= (1u << 30); p2 <<= 1) {
    const size_t fit = (budget - p2 * sizeof(int)) / (kFloatPlanes * sizeof(float));
    const size_t n = fit < p2 ? fit : p2;
    if (n > best) best = n;
  }
  *out = static_cast<int>(best);
  return cudaSuccess;
}

const char* fdtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
