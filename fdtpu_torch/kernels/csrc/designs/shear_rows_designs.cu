// The designs of the row shear that shear_rows_kernel (../rotate_shear.cu)
// was chosen over, kept so that the choice can be measured again:
//
//     python -m fdtpu_torch.bench_shear_designs
//
// builds this file into a library of its own, holds every design bit-equal
// to the plain version and times each against the shipped kernel on K4's
// and K3a's planes. Nothing in the port launches these. Each computes
// shear_rows with the shipped kernel's arithmetic (blend() with the
// round-to-nearest intrinsics), on planes whose rows and pointers are on the
// 16-byte grid and with c <= VEC; the entry point refuses anything else.
//
// shipped: shear_rows_kernel itself, from the file included below: one
//   64-vector step a warp, staged in shared memory by 16-byte cp.async, 4
//   warps a CTA.
// shuffle: the window built in registers. A CTA of 8 warps owns a band of
//   rows of one plane, and a warp walks its rows 32 vectors a step. Each
//   lane loads its aligned input vector v + q once and takes v + q + 1 (and
//   v + q + 2 when m + c > VEC) from the next lanes by __shfl_sync, lanes 0
//   and 1 loading the two vectors past the warp's end. The next step's
//   loads are issued before the current one is blended, so two steps (34
//   vectors each) are in flight a warp. No shared memory.
// ring<S, R>: a warp walks a run of R consecutive 64-vector steps, cut as
//   the shipped kernel cuts them, staging each step's 66 vectors by 16-byte
//   cp.async into one of S slots, S - 1 steps ahead of the one it blends; 4
//   warps a CTA. ring<1, 1> is the shipped kernel's structure.
// bulk<S, R>: the same ring, each slot filled by one TMA 1-D bulk copy
//   (cp.async.bulk) of the step's vectors inside the row, completing on the
//   slot's mbarrier; the lanes write the zeros outside the row. A wait that
//   lasts about a second traps, so a copy that never lands fails the launch.

#include "../rotate_shear.cu"

#include <cstdint>
#include <cstring>

namespace {

enum Design { kShipped = 0, kShuffle = 1, kRing = 2, kBulk = 3 };

// -- shuffle -----------------------------------------------------------------------

constexpr int kShflWarps = 8;
constexpr int kShflVecs = 32;         // vectors a warp step
constexpr int kShflStepsPerWarp = 8;  // the launch sizes bands to about this
constexpr unsigned kFullMask = 0xffffffffu;

// A 16-byte pack from lane `src` of the warp, word by word.
template <typename P>
__device__ __forceinline__ P shfl_pack(const P& x, int src) {
  static_assert(sizeof(P) == 16, "16-byte packs only");
  unsigned w[4];
  memcpy(w, &x, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __shfl_sync(kFullMask, w[i], src);
  P y;
  memcpy(&y, w, 16);
  return y;
}

// The vector d places further along the row than this lane's `x`: lane
// + d's, or past the warp's last lane, the `extra` of lane (lane + d) - 32.
template <typename P>
__device__ __forceinline__ P next_vec(const P& x, const P& extra, int lane, int d) {
  const int src = (lane + d) & 31;
  const P own = shfl_pack(x, src), past = shfl_pack(extra, src);
  return lane + d < 32 ? own : past;
}

// Vector v of a row of nvec, or zeros outside it.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> vec_or_zero(const T* row, int v, int nvec) {
  Pack<T, VEC> p = {};
  if (v >= 0 && v < nvec) {
    p = *reinterpret_cast<const Pack<T, VEC>*>(row + static_cast<size_t>(v) * VEC);
  }
  return p;
}

// A row's taps: lane l blends in[l + s] and in[l + s + c] by f, with
// s = qa VEC + ma and s + c = qb VEC + mb; a shift past either end reads
// only zeros, and clamping it there keeps s in range.
struct RowShift {
  float f;
  int qa, ma, qb, mb;
};

template <int VEC>
__device__ __forceinline__ RowShift row_shift(float kp, int rr, float center, int c, int lanes) {
  const float t = __fmul_rn(kp, __fsub_rn(static_cast<float>(rr), center));
  const float n = floorf(t);
  const float n_hi = static_cast<float>(lanes / c);
  RowShift g;
  g.f = __fsub_rn(t, n);
  const int s = static_cast<int>(fminf(fmaxf(n, -n_hi - 1.f), n_hi)) * c;
  g.qa = floor_div<VEC>(s);
  g.ma = s - g.qa * VEC;
  g.qb = floor_div<VEC>(s + c);
  g.mb = s + c - g.qb * VEC;
  return g;
}

template <typename P>
struct StepLoads {
  P x, extra;  // this lane's first-tap vector; lanes 0 and 1: the two past the warp
};

template <typename T>
__global__ void __launch_bounds__(kShflWarps * 32)
    shuffle_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ k,
                   int rows, int lanes, int c, int row_mod, float center, int bands,
                   int rows_per_warp) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = lanes / VEC;
  const int steps = (nvec + kShflVecs - 1) / kShflVecs;
  const int plane = blockIdx.x / bands;
  const int lane = threadIdx.x % 32;
  const int r_begin =
      ((blockIdx.x - plane * bands) * kShflWarps + threadIdx.x / 32) * rows_per_warp;
  const int r_end = min(r_begin + rows_per_warp, rows);
  if (r_begin >= r_end) return;  // the whole warp
  const size_t plane_off = static_cast<size_t>(plane) * rows * lanes;
  const T* src = in + plane_off;
  T* dst = out + plane_off;
  const float kp = k[plane];

  auto issue = [&](int r, int step, const RowShift& g) {
    const T* row = src + static_cast<size_t>(r) * lanes;
    const int v = step * kShflVecs + lane;
    StepLoads<P> ld;
    ld.x = vec_or_zero<T, VEC>(row, v + g.qa, nvec);
    ld.extra = P{};
    if (lane < 2) ld.extra = vec_or_zero<T, VEC>(row, v + kShflVecs + g.qa, nvec);
    return ld;
  };

  auto finish = [&](int r, int step, const RowShift& g, const StepLoads<P>& ld) {
    const P x1 = next_vec(ld.x, ld.extra, lane, 1);
    const P a = window<T, VEC>(ld.x, x1, g.ma);
    P b;
    if (g.qb == g.qa) {
      b = window<T, VEC>(ld.x, x1, g.mb);
    } else {  // qb = qa + 1: c <= VEC
      const P x2 = g.mb > 0 ? next_vec(ld.x, ld.extra, lane, 2) : x1;
      b = window<T, VEC>(x1, x2, g.mb);
    }
    const int v = step * kShflVecs + lane;
    if (v < nvec) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(&o.v[e], blend(load(&a.v[e]), load(&b.v[e]), g.f));
      *reinterpret_cast<P*>(dst + static_cast<size_t>(r) * lanes + static_cast<size_t>(v) * VEC) =
          o;
    }
  };

  // rr = r mod row_mod (r with row_mod 0), advanced by a counter
  int rr = row_mod > 0 ? r_begin % row_mod : r_begin;
  int r = r_begin, step = 0;
  RowShift g = row_shift<VEC>(kp, rr, center, c, lanes);
  StepLoads<P> cur = issue(r, step, g);
  for (;;) {
    int r2 = r, step2 = step + 1;
    RowShift g2 = g;
    if (step2 == steps) {
      step2 = 0;
      ++r2;
      rr = (row_mod > 0 && rr + 1 == row_mod) ? 0 : rr + 1;
      g2 = row_shift<VEC>(kp, rr, center, c, lanes);
    }
    const bool more = r2 < r_end;
    StepLoads<P> nxt;
    if (more) nxt = issue(r2, step2, g2);  // in flight while this step blends
    finish(r, step, g, cur);
    if (!more) break;
    r = r2;
    step = step2;
    g = g2;
    cur = nxt;
  }
}

template <typename T>
cudaError_t launch_shuffle(const T* in, T* out, const float* k, int planes, int rows, int lanes,
                           int c, int row_mod, float center, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int steps = (lanes / kVec + kShflVecs - 1) / kShflVecs;
  const int rows_per_warp = steps < kShflStepsPerWarp ? kShflStepsPerWarp / steps : 1;
  const int band_rows = kShflWarps * rows_per_warp;
  const int bands = (rows + band_rows - 1) / band_rows;
  const long long blocks = static_cast<long long>(planes) * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  shuffle_kernel<T><<<static_cast<unsigned>(blocks), kShflWarps * 32, 0, s>>>(
      in, out, k, rows, lanes, c, row_mod, center, bands, rows_per_warp);
  return cudaGetLastError();
}

// -- ring and bulk ---------------------------------------------------------------

// Where flat step t of the planes lies: its row (plane * rows + r), its
// first vector and the row's taps; a few divisions a step, computed as
// shear_rows_kernel computes them.
struct StepAt {
  int row, base;
  RowShift g;
};

template <int VEC>
__device__ __forceinline__ StepAt step_at(long long t, const float* __restrict__ k, int rows,
                                          int steps, int lanes, int c, int row_mod,
                                          float center) {
  StepAt st;
  st.row = static_cast<int>(t / steps);
  st.base = static_cast<int>(t - static_cast<long long>(st.row) * steps) * kWarpVecs;
  const int plane = st.row / rows;
  const int r = st.row - plane * rows;
  const int rr = row_mod > 0 ? r % row_mod : r;
  st.g = row_shift<VEC>(k[plane], rr, center, c, lanes);
  return st;
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// the barriers' initialisation visible to the asynchronous proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of a phase, which also expects `bytes` of copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both ends on the 16-byte grid) from device to
// shared memory by the TMA unit, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// this thread's shared-memory accesses ordered before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wait for the phase of `parity` to complete; trap after about a second
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// Stage step `st` into `slot`: vectors [v0, v0 + kSlotVecs) of its row
// from the first tap's aligned vector v0, zeros outside the row; by 16-byte
// cp.async (the caller commits), or by one bulk copy counted on `bar`.
template <typename T, int VEC, bool kTma>
__device__ __forceinline__ void stage_step(const T* __restrict__ in, const StepAt& st,
                                           int lanes, int lane, Pack<T, VEC>* slot,
                                           uint64_t* bar) {
  using P = Pack<T, VEC>;
  const int nvec = lanes / VEC;
  const T* row = in + static_cast<size_t>(st.row) * lanes;
  const int v0 = st.base + st.g.qa;
  if constexpr (kTma) {
    const int lo = max(v0, 0), hi = min(v0 + kSlotVecs, nvec);
    for (int i = lane; i < kSlotVecs; i += 32) {
      if (v0 + i < lo || v0 + i >= hi) slot[i] = P{};
    }
    if (lane == 0) {
      const unsigned bytes = hi > lo ? static_cast<unsigned>(hi - lo) * sizeof(P) : 0u;
      mbar_arrive_expect(bar, bytes);
      if (bytes) bulk_copy(slot + (lo - v0), row + static_cast<size_t>(lo) * VEC, bytes, bar);
    }
  } else {
    for (int i = lane; i < kSlotVecs; i += 32) {
      const int v = v0 + i;
      const bool ok = v >= 0 && v < nvec;
      cp_async16_line(slot + i, ok ? row + static_cast<size_t>(v) * VEC : row, ok);
    }
  }
}

// Blend step `st` from its staged slot, as shear_rows_kernel does: a from
// vectors (j, j + 1) of the slot, j = lane + 32 u; b from the same pair or
// the next (qb = qa + 1, c <= VEC).
template <typename T, int VEC>
__device__ __forceinline__ void blend_step(const Pack<T, VEC>* slot, const StepAt& st,
                                           int lanes, int lane, T* __restrict__ out) {
  using P = Pack<T, VEC>;
  const int nvec = lanes / VEC;
  const bool next = st.g.qb != st.g.qa;
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    const int j = lane + 32 * u;
    const P x0 = slot[j], x1 = slot[j + 1], x2 = slot[j + 2];
    const P a = window<T, VEC>(x0, x1, st.g.ma);
    // copied out first: a reference bound to a runtime choice of x0, x1 or
    // x2 would put all three in local memory
    const P lo = next ? x1 : x0, hi = next ? x2 : x1;
    const P b = window<T, VEC>(lo, hi, st.g.mb);
    const int v = st.base + j;
    if (v < nvec) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(&o.v[e], blend(load(&a.v[e]), load(&b.v[e]), st.g.f));
      *reinterpret_cast<P*>(out + static_cast<size_t>(st.row) * lanes +
                            static_cast<size_t>(v) * VEC) = o;
    }
  }
}

template <typename T, int kStages, int kRun, bool kTma>
__global__ void __launch_bounds__(kRowsWarps * 32)
    staged_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ k,
                  int planes, int rows, int lanes, int c, int row_mod, float center) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  __shared__ __align__(16) unsigned char ring_bytes[kRowsWarps * kStages * kSlotVecs * sizeof(P)];
  __shared__ __align__(8) uint64_t bars[kRowsWarps][kStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  P* ring = reinterpret_cast<P*>(ring_bytes) + warp * kStages * kSlotVecs;
  uint64_t* bar = bars[warp];

  // this warp's run of steps, from step t0 of the planes' rows * steps
  const int steps = (lanes / VEC + kWarpVecs - 1) / kWarpVecs;
  const long long total = static_cast<long long>(planes) * rows * steps;
  const long long t0 = (static_cast<long long>(blockIdx.x) * kRowsWarps + warp) * kRun;
  if (t0 >= total) return;  // the whole warp
  const int tasks = static_cast<int>(total - t0 < kRun ? total - t0 : kRun);
  auto at = [&](int i) {
    return step_at<VEC>(t0 + i, k, rows, steps, lanes, c, row_mod, center);
  };
  if constexpr (kTma) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) mbar_init(&bar[i]);
      mbar_fence_init();
    }
    __syncwarp();
  }

  // kStages - 1 steps in flight before the first is blended; cp.async
  // commits one group a step, even an empty one
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tasks) {
      stage_step<T, VEC, kTma>(in, at(j), lanes, lane, ring + j * kSlotVecs, &bar[j]);
    }
    if constexpr (!kTma) cp_async_commit();
  }
  for (int i = 0; i < tasks; ++i) {
    const int ahead = i + kStages - 1, st = ahead % kStages;
    StepAt next;
    if (ahead < tasks) {
      next = at(ahead);
      stage_step<T, VEC, kTma>(in, next, lanes, lane, ring + st * kSlotVecs, &bar[st]);
    }
    if constexpr (kTma) {
      __syncwarp();  // the zeros the other lanes wrote
      mbar_wait(&bar[i % kStages], (i / kStages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait_n<kStages - 1>();
      __syncwarp();
    }
    const StepAt cur = kStages == 1 ? next : at(i);
    blend_step<T, VEC>(ring + (i % kStages) * kSlotVecs, cur, lanes, lane, out);
    if constexpr (kTma) fence_proxy_async();  // these reads before the slot's next copy
    __syncwarp();
  }
}

template <typename T, int kStages, int kRun, bool kTma>
cudaError_t launch_staged(const T* in, T* out, const float* k, int planes, int rows, int lanes,
                          int c, int row_mod, float center, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const long long steps = (lanes / kVec + kWarpVecs - 1) / kWarpVecs;
  const long long total = static_cast<long long>(planes) * rows * steps;
  const long long blocks = (total + kRowsWarps * kRun - 1) / (kRowsWarps * kRun);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  staged_kernel<T, kStages, kRun, kTma><<<static_cast<unsigned>(blocks), kRowsWarps * 32, 0, s>>>(
      in, out, k, planes, rows, lanes, c, row_mod, center);
  return cudaGetLastError();
}

// The (stages, run) pairs built; `fn` gets the instance's kernel and launch.
template <typename T, bool kTma, typename F>
cudaError_t with_staged(int stages, int run, F fn) {
  if (stages == 1 && run == 1) {
    return fn(staged_kernel<T, 1, 1, kTma>, launch_staged<T, 1, 1, kTma>);
  }
  if (stages == 2 && run == 2) {
    return fn(staged_kernel<T, 2, 2, kTma>, launch_staged<T, 2, 2, kTma>);
  }
  if (stages == 2 && run == 8) {
    return fn(staged_kernel<T, 2, 8, kTma>, launch_staged<T, 2, 8, kTma>);
  }
  if (stages == 4 && run == 8) {
    return fn(staged_kernel<T, 4, 8, kTma>, launch_staged<T, 4, 8, kTma>);
  }
  if (stages == 8 && run == 8) {
    return fn(staged_kernel<T, 8, 8, kTma>, launch_staged<T, 8, 8, kTma>);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_design(int design, int stages, int run, const T* in, T* out, const float* k,
                          int planes, int rows, int lanes, int c, int row_mod, float center,
                          cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) % 16 == 0 &&
                       (static_cast<size_t>(lanes) * sizeof(T)) % 16 == 0;
  if (!aligned || c < 1 || c > kVec) return cudaErrorInvalidValue;
  auto launch = [&](auto, auto fn) {
    return fn(in, out, k, planes, rows, lanes, c, row_mod, center, s);
  };
  switch (design) {
    case kShipped:
      return launch_shear_rows(in, out, k, planes, rows, lanes, c, row_mod, center, s);
    case kShuffle:
      return launch_shuffle(in, out, k, planes, rows, lanes, c, row_mod, center, s);
    case kRing:
      return with_staged<T, false>(stages, run, launch);
    case kBulk:
      return with_staged<T, true>(stages, run, launch);
    default:
      return cudaErrorInvalidValue;
  }
}

// Registers a thread, threads a CTA, static shared bytes a CTA, resident
// CTAs an SM and local (stack or spill) bytes a thread of a design's
// aligned instance.
template <typename T>
cudaError_t design_attributes(int design, int stages, int run, int* out5) {
  auto attrs = [&](const void* fn, int threads) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, 0);
    out5[0] = a.numRegs;
    out5[1] = threads;
    out5[2] = static_cast<int>(a.sharedSizeBytes);
    out5[3] = ctas;
    out5[4] = static_cast<int>(a.localSizeBytes);
    return err;
  };
  constexpr int kVec = 16 / sizeof(T);
  switch (design) {
    case kShipped:
      return attrs(reinterpret_cast<const void*>(shear_rows_kernel<T, kVec, false>),
                   kRowsWarps * 32);
    case kShuffle:
      return attrs(reinterpret_cast<const void*>(shuffle_kernel<T>), kShflWarps * 32);
    case kRing:
    case kBulk: {
      auto of = [&](auto kernel, auto) {
        return attrs(reinterpret_cast<const void*>(kernel), kRowsWarps * 32);
      };
      return design == kRing ? with_staged<T, false>(stages, run, of)
                             : with_staged<T, true>(stages, run, of);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch design `design` (0 shipped, 1 shuffle, 2 ring, 3 bulk; `stages`
// and `run` pick the ring's instance: (1, 1), (2, 2), (2, 8), (4, 8) or
// (8, 8)) on `stream`, with fdtpu_shear_rows's other arguments. Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for an instance not
// built, planes off the 16-byte grid or c > VEC.
int fdtpu_shear_rows_design(int design, int stages, int run, const void* in, void* out,
                            const void* k, int bf16, int planes, int rows, int lanes, int c,
                            int row_mod, float center, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  if (bf16) {
    return launch_design(design, stages, run, static_cast<const __nv_bfloat16*>(in),
                         static_cast<__nv_bfloat16*>(out), kk, planes, rows, lanes, c, row_mod,
                         center, s);
  }
  return launch_design(design, stages, run, static_cast<const float*>(in),
                       static_cast<float*>(out), kk, planes, rows, lanes, c, row_mod, center, s);
}

// A design's registers a thread, threads a CTA, static shared bytes a CTA,
// resident CTAs an SM and local bytes a thread, into out5[0..4].
int fdtpu_shear_rows_design_attributes(int design, int stages, int run, int bf16, int* out5) {
  return bf16 ? design_attributes<__nv_bfloat16>(design, stages, run, out5)
              : design_attributes<float>(design, stages, run, out5);
}

}  // extern "C"
