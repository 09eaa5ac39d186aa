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
// and writes one, with 8 flops, and no input byte is used by another row;
// at 26 x 512 x 1536 bf16 planes a pass must move 82 MB (0.0244 ms at
// 3.35 TB/s).
//
// shear_rows serves K3a (c = 3, row_mod = 0) and K4 (c = 1, row_mod = the
// block period Hp, or 0 for the vertical pass on the transpose). Its first
// design gave each plane row a CTA of 256 threads, each lane loaded as two
// scalars and stored as one: a warp instruction moved 64 bytes in bf16, so
// about 4 KB was in flight on an SM where ~18 KB is needed (3.35 TB/s times
// ~0.7 us of latency over 132 SMs). It reached 34% of the bound on K4's
// 512-lane bf16 rows (65% in f32, 56% on K3a's 1536-lane rows).
// Now every global load and store is a 16-byte vector (8 bf16 or 4 f32
// lanes). The rows are cut into steps of 64 vectors; a warp owns one step,
// a CTA of 4 warps four consecutive steps, and the card schedules the many
// short CTAs as SMs free up. A row's shift s = n c is the same for the
// warp: with s = q VEC + m, the warp stages vectors [v + q, v + q + 66) of
// its row in shared memory by 16-byte cp.async, which writes zeros for
// vectors outside the row (its ends are on the vector grid, so those are
// exactly the taps outside it) and has the L2 fetch whole 128-byte lines.
// Each lane then blends its two output vectors j = lane and lane + 32 from
// slot vectors j, j + 1 and, when the second tap reaches it (m + c > VEC),
// j + 2, picking the taps by a branch on m, uniform in the warp, so each
// case is register moves. Row, plane and r mod row_mod cost a few
// divisions a warp, none an element. A second tap more than a vector away
// (c > VEC), and planes off the 16-byte grid (lanes * size % 16 != 0, or a
// view at an odd offset), take the same kernel with one element a vector
// and plain copies into the slot; with c > 1 there the second tap is staged
// as its own vectors.
// The designs it was chosen over were timed against it by a study whose
// code has since gone; its figures stay here. On an
// H100 80GB HBM3 at 700 W, K4's bf16 planes (26, 1536, 512): this kernel
// 0.0332 ms (73% of the bound, 92% of a Tensor.copy_ of the planes); the
// window built by warp shuffles, two steps in flight a warp, 0.0476 (51%);
// a warp walking runs of 2-8 steps through a ring of 2-8 cp.async slots,
// 0.038-0.048, slower the more steps a warp; the same single step staged by
// one TMA bulk copy and an mbarrier, 0.0339.
//
// shear_cols: a lane's shift is fixed, so a lane is a column walked down the
// rows. Done per element, as a first version did, each output recomputes
// its coefficients (with an integer division), loads both taps as scalars
// from rows that differ across a warp, and loads each input twice; that
// reached a third of the bound. Here a CTA of 128 threads owns a tile of 16
// vectors of 16 bytes across lanes (128 bf16 or 64 f32 lanes, 256 bytes a
// row) by kBandRows = 128 output rows of one plane. From the least and
// greatest shift over its lanes (shifts are monotone in the lane) it knows
// the input rows it reads: its own plus a halo of n_max - n_min + 1 (17 at
// most for bf16 with c = 3 and |k| <= sin 20 deg, 10 for f32). It computes
// its band kStepRows = 32 rows at a time from a ring of 128 staged input
// rows (32 KB), filled by 16-byte cp.async (zeros for rows outside the
// plane): while one step computes, the next step's 32 new rows are in
// flight, and every input row of the band is staged once. Each thread owns
// one vector of lanes, computes t, n and f for them once, and walks a run
// of 4 consecutive rows: a row's upper taps are the next row's lower ones,
// so it reads span + 1 vectors of shared memory a row (span = the spread of
// n over the vector: 0 or 1 for c = 3 at 20 deg), picks each lane's new
// tap, blends, and writes one 16-byte vector. Nothing is loaded or stored
// as a scalar, and the coefficients cost nothing a row.
// Edges in the same launch: a ragged last tile, band and step; a shear so
// steep that two steps and the halo outgrow the ring reads its taps
// straight from device memory. Planes whose pointers or row length are off
// the 16-byte grid (lanes * size % 16 != 0, or a view at an odd offset)
// take the same kernel with one element a vector and plain copies into the
// ring.
//
// Built by fdtpu_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

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

// shear_cols tiling: kTileVecs vectors across lanes by kRowGroups groups
// of rows; a CTA owns kBandRows output rows of its tile and computes them
// kStepRows at a time from a ring of kRingRows staged input rows.
constexpr int kColsThreads = 128;
constexpr int kTileVecs = 16;
constexpr int kRowGroups = kColsThreads / kTileVecs;
constexpr int kStepRows = 32;
constexpr int kBandRows = 128;
constexpr int kRingRows = 128;  // a power of two

// VEC plane elements moved as one load or store (16 bytes, or a scalar).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// 16 bytes from device to shared memory without a register, or 16 zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
// The same, and the L2 fetches the whole 128-byte line from device memory.
__device__ __forceinline__ void cp_async16_line(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// shear_rows: the planes' rows are cut into steps of kWarpVecs vectors (the
// last of a row may be short), one a warp, kRowsWarps consecutive steps a
// CTA. A warp stages its step's input in shared memory and blends it.
constexpr int kRowsWarps = 4;
constexpr int kLaneVecs = 2;  // output vectors a lane blends
constexpr int kWarpVecs = 32 * kLaneVecs;
constexpr int kSlotVecs = kWarpVecs + 2;  // a step's first tap and the two vectors past it

template <int VEC>
__device__ __forceinline__ int floor_div(int s) {
  return (s >= 0 ? s : s - (VEC - 1)) / VEC;
}

// Elements [m, m + VEC) of the pair (lo, hi); m is uniform in the warp, and
// each case copies at fixed places, so nothing goes through local memory.
template <typename T, int VEC, int M = 0>
__device__ __forceinline__ Pack<T, VEC> window(const Pack<T, VEC>& lo, const Pack<T, VEC>& hi,
                                               int m) {
  if constexpr (M + 1 < VEC) {
    if (m != M) return window<T, VEC, M + 1>(lo, hi, m);
  }
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    o.v[j] = M + j < VEC ? lo.v[(M + j) % VEC] : hi.v[(M + j) % VEC];
  }
  return o;
}

template <typename T, int VEC, bool kFar>
__global__ void __launch_bounds__(kRowsWarps * 32)
    shear_rows_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ k,
                      int planes, int rows, int lanes, int c, int row_mod, float center) {
  using P = Pack<T, VEC>;
  // a warp's slot: the step's first-tap vectors; with kFar the second tap's too
  constexpr int kSlot = (kFar ? 2 : 1) * kSlotVecs;
  __shared__ __align__(16) unsigned char slot_bytes[kRowsWarps * kSlot * sizeof(P)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  P* slot = reinterpret_cast<P*>(slot_bytes) + warp * kSlot;

  // this warp's step: its row (plane * rows + r), r mod row_mod, and where
  // in the row it starts; divisions a warp, none an element
  const int nvec = lanes / VEC;
  const int steps = (nvec + kWarpVecs - 1) / kWarpVecs;
  const long long t = static_cast<long long>(blockIdx.x) * kRowsWarps + warp;
  if (t >= static_cast<long long>(planes) * rows * steps) return;  // the whole warp
  const int row = static_cast<int>(t / steps);
  const int base = static_cast<int>(t - static_cast<long long>(row) * steps) * kWarpVecs;
  const int plane = row / rows;
  const int r = row - plane * rows;
  const int rr = row_mod > 0 ? r % row_mod : r;

  // the row's taps: lane l blends in[l + s] and in[l + s + c] by f, with
  // s = qa VEC + ma and s + c = qb VEC + mb; a shift past either end reads
  // only zeros, and clamping it there keeps s in range
  const float tr = __fmul_rn(k[plane], __fsub_rn(static_cast<float>(rr), center));
  const float n = floorf(tr);
  const float f = __fsub_rn(tr, n);
  const float n_hi = static_cast<float>(lanes / c);
  const int s = static_cast<int>(fminf(fmaxf(n, -n_hi - 1.f), n_hi)) * c;
  const int qa = floor_div<VEC>(s), ma = s - qa * VEC;
  const int qb = floor_div<VEC>(s + c), mb = s + c - qb * VEC;

  // Stage vectors [v0, v0 + kSlotVecs) of the row from the first tap's
  // aligned vector v0 (zeros outside the row): 16-byte cp.async, else
  // plain copies.
  const T* src = in + static_cast<size_t>(row) * lanes;
#pragma unroll
  for (int region = 0; region < (kFar ? 2 : 1); ++region) {
    const int v0 = base + (region ? qb : qa);
    for (int i = lane; i < kSlotVecs; i += 32) {
      const int v = v0 + i;
      const bool ok = v >= 0 && v < nvec;
      const T* from = ok ? src + static_cast<size_t>(v) * VEC : src;
      if constexpr (sizeof(P) == 16) {
        cp_async16_line(slot + region * kSlotVecs + i, from, ok);
      } else {
        P val = {};
        if (ok) val = *reinterpret_cast<const P*>(from);
        slot[region * kSlotVecs + i] = val;
      }
    }
  }
  if constexpr (sizeof(P) == 16) {
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncwarp();

  // a from vectors (j, j + 1) of the slot, j = lane + 32 u; b from the same
  // pair, the next pair (qb = qa + 1, c <= VEC), or with kFar its own
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    const int j = lane + 32 * u;
    const P x0 = slot[j], x1 = slot[j + 1];
    const P a = window<T, VEC>(x0, x1, ma);
    P lo, hi;
    if constexpr (kFar) {
      lo = slot[kSlotVecs + j];
      hi = slot[kSlotVecs + j + 1];
    } else {
      const bool next = qb != qa;
      const P x2 = slot[j + 2];
      lo = next ? x1 : x0;
      hi = next ? x2 : x1;
    }
    const P b = window<T, VEC>(lo, hi, mb);
    const int v = base + j;
    if (v < nvec) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(&o.v[e], blend(load(&a.v[e]), load(&b.v[e]), f));
      *reinterpret_cast<P*>(out + static_cast<size_t>(row) * lanes + static_cast<size_t>(v) * VEC) =
          o;
    }
  }
}

template <typename T>
cudaError_t launch_shear_rows(const T* in, T* out, const float* k, int planes, int rows,
                              int lanes, int c, int row_mod, float center, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte vectors where the planes are on the grid and the second tap is
  // at most a vector away (c <= VEC); else one element a vector
  const bool vec = c <= kVec &&
                   (reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) % 16 == 0 &&
                   (static_cast<size_t>(lanes) * sizeof(T)) % 16 == 0;
  const int vlen = vec ? kVec : 1;
  const long long steps = (lanes / vlen + kWarpVecs - 1) / kWarpVecs;
  const long long blocks =
      (static_cast<long long>(planes) * rows * steps + kRowsWarps - 1) / kRowsWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kRowsWarps * 32);
  if (vec) {
    shear_rows_kernel<T, kVec, false><<<grid, block, 0, s>>>(in, out, k, planes, rows, lanes, c,
                                                             row_mod, center);
  } else if (c == 1) {
    shear_rows_kernel<T, 1, false><<<grid, block, 0, s>>>(in, out, k, planes, rows, lanes, c,
                                                          row_mod, center);
  } else {
    shear_rows_kernel<T, 1, true><<<grid, block, 0, s>>>(in, out, k, planes, rows, lanes, c,
                                                         row_mod, center);
  }
  return cudaGetLastError();
}

// The row shift of lane l: floor(k ((l / c) - center)).
__device__ __forceinline__ float shear_t(float kp, int l, int c, float center) {
  return __fmul_rn(kp, __fsub_rn(static_cast<float>(l / c), center));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kColsThreads)
    shear_cols_kernel(const T* __restrict__ in, T* __restrict__ out,
                      const float* __restrict__ k, int rows, int lanes, int c,
                      float center) {
  using P = Pack<T, VEC>;
  constexpr bool kAsync = sizeof(P) == 16;
  constexpr int kTileLanes = kTileVecs * VEC;
  __shared__ __align__(16) unsigned char ring_bytes[kRingRows * kTileVecs * sizeof(P)];
  P* ring = reinterpret_cast<P*>(ring_bytes);

  const int plane = blockIdx.z;
  const int l0 = blockIdx.x * kTileLanes;
  const int band0 = blockIdx.y * kBandRows;
  const int band_end = min(band0 + kBandRows, rows);
  const size_t plane_off = static_cast<size_t>(plane) * rows * lanes;
  const T* src = in + plane_off;
  T* dst = out + plane_off;
  const float kp = k[plane];

  // the tile's least and greatest shift, at its first and last lane
  const float na = floorf(shear_t(kp, l0, c, center));
  const float nb = floorf(shear_t(kp, min(l0 + kTileLanes, lanes) - 1, c, center));
  const float halo_f = fabsf(na - nb) + 1.f;  // input rows a step reads beyond its own
  const int nmin = static_cast<int>(fminf(na, nb));

  // this thread's vector of lanes: shift and weight of each lane, once
  const int vec = threadIdx.x % kTileVecs, group = threadIdx.x / kTileVecs;
  const int lane0 = l0 + vec * VEC;
  const bool active = lane0 < lanes;
  int n[VEC];
  float f[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float t = shear_t(kp, min(lane0 + j, lanes - 1), c, center);
    const float fl = floorf(t);
    f[j] = __fsub_rn(t, fl);
    n[j] = static_cast<int>(fl);
  }

  if (!(halo_f + 2 * kStepRows <= static_cast<float>(kRingRows))) {
    // a halo beyond the ring (or a non-finite k): taps from device memory
    if (!active) return;
    for (int r = band0 + group; r < band_end; r += kRowGroups) {
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const long long r0 = static_cast<long long>(r) + n[j], r1 = r0 + 1;
        const size_t col = static_cast<size_t>(lane0 + j);
        const float a = (r0 >= 0 && r0 < rows) ? load(src + r0 * lanes + col) : 0.f;
        const float b = (r1 >= 0 && r1 < rows) ? load(src + r1 * lanes + col) : 0.f;
        store(&o.v[j], blend(a, b, f[j]));
      }
      *reinterpret_cast<P*>(dst + static_cast<size_t>(r) * lanes + lane0) = o;
    }
    return;
  }
  const int halo = static_cast<int>(halo_f);

  // Input row g lives in ring row g mod kRingRows, rows outside the plane
  // as zeros. Stage rows [g0, g1): 16-byte cp.async, else plain copies.
  auto stage_rows = [&](int g0, int g1) {
    for (int i = threadIdx.x; i < (g1 - g0) * kTileVecs; i += kColsThreads) {
      const int g = g0 + i / kTileVecs, v = i % kTileVecs;
      const int gl = l0 + v * VEC;
      P* slot = &ring[(g & (kRingRows - 1)) * kTileVecs + v];
      const bool ok = g >= 0 && g < rows && gl < lanes;
      const T* from = ok ? src + static_cast<size_t>(g) * lanes + gl : src;
      if constexpr (kAsync) {
        cp_async16(slot, from, ok);
      } else {
        P val = {};
        if (ok) val = *reinterpret_cast<const P*>(from);
        *slot = val;
      }
    }
    if constexpr (kAsync) cp_async_commit();
  };

  // lane j's taps at output row r: input rows r + nlo + d(j) and the next;
  // d(j) <= span < kRingRows fits a byte, four to a register
  const int nlo = min(n[0], n[VEC - 1]);
  const int span = abs(n[VEC - 1] - n[0]);
  unsigned dpack[(VEC + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < VEC; ++j) dpack[j / 4] |= static_cast<unsigned>(n[j] - nlo) << (8 * (j % 4));
  auto d = [&](int j) { return static_cast<int>((dpack[j / 4] >> (8 * (j % 4))) & 0xffu); };
  auto row_of = [&](int g) -> const P& {
    return ring[(g & (kRingRows - 1)) * kTileVecs + vec];
  };

  // Step s computes output rows [r0, r0 + kStepRows) from input rows
  // [r0 + nmin, r0 + kStepRows + nmin + halo). While it runs, the next
  // step's new rows are in flight: the ring holds 2 steps and a halo.
  int staged = band0 + kStepRows + nmin + halo;
  stage_rows(band0 + nmin, staged);
  for (int r0 = band0; r0 < band_end; r0 += kStepRows) {
    if (r0 + kStepRows < band_end) {
      const int next = r0 + 2 * kStepRows + nmin + halo;
      stage_rows(staged, next);
      staged = next;
    } else if constexpr (kAsync) {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    if constexpr (kAsync) cp_async_wait_one();
    __syncthreads();
    // each group walks a run of consecutive rows: a row's upper taps are
    // the next row's lower ones, so after the run's first row only the new
    // lower taps are read, span + 1 vectors a row
    constexpr int kRun = kStepRows / kRowGroups;
    const int r_begin = r0 + group * kRun, r_end = min(r_begin + kRun, band_end);
    if (active && r_begin < r_end) {
      float a[VEC] = {}, b[VEC] = {};
      for (int s = 0; s <= span + 1; ++s) {
        const P v = row_of(r_begin + nlo + s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x = load(&v.v[j]);
          if (d(j) == s) a[j] = x;
          if (d(j) + 1 == s) b[j] = x;
        }
      }
      for (int r = r_begin;;) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) store(&o.v[j], blend(a[j], b[j], f[j]));
        *reinterpret_cast<P*>(dst + static_cast<size_t>(r) * lanes + lane0) = o;
        if (++r == r_end) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) a[j] = b[j];
        for (int s = 0; s <= span; ++s) {
          const P v = row_of(r + nlo + 1 + s);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            if (d(j) == s) b[j] = load(&v.v[j]);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_shear_cols(const T* in, T* out, const float* k, int planes,
                              int rows, int lanes, int c, float center,
                              cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) % 16 == 0 &&
                   (static_cast<size_t>(lanes) * sizeof(T)) % 16 == 0;
  const int tile = kTileVecs * (vec ? kVec : 1);
  const dim3 grid((lanes + tile - 1) / tile, (rows + kBandRows - 1) / kBandRows,
                  planes);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (vec) {
    shear_cols_kernel<T, kVec><<<grid, kColsThreads, 0, s>>>(in, out, k, rows, lanes, c, center);
  } else {
    shear_cols_kernel<T, 1><<<grid, kColsThreads, 0, s>>>(in, out, k, rows, lanes, c, center);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// shear_rows: launch on `stream`, a warp every 64 vectors of a row. `in`, `out`:
// (planes, rows, lanes) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); `k`:
// (planes,) f32 on the card. Returns the cudaError_t of the launch (0 on success).
int fdtpu_shear_rows(const void* in, void* out, const void* k, int bf16,
                     int planes, int rows, int lanes, int c, int row_mod,
                     float center, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  if (bf16) {
    return launch_shear_rows(static_cast<const __nv_bfloat16*>(in),
                             static_cast<__nv_bfloat16*>(out), kk, planes, rows, lanes, c,
                             row_mod, center, s);
  }
  return launch_shear_rows(static_cast<const float*>(in), static_cast<float*>(out), kk, planes,
                           rows, lanes, c, row_mod, center, s);
}

// Launch on `stream`: one CTA per tile of 16 vectors of lanes by 128-row band of
// a plane. Same arguments as fdtpu_shear_rows without row_mod.
int fdtpu_shear_cols(const void* in, void* out, const void* k, int bf16,
                     int planes, int rows, int lanes, int c, float center,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  if (bf16) {
    return launch_shear_cols(static_cast<const __nv_bfloat16*>(in),
                             static_cast<__nv_bfloat16*>(out), kk, planes, rows,
                             lanes, c, center, s);
  }
  return launch_shear_cols(static_cast<const float*>(in), static_cast<float*>(out),
                           kk, planes, rows, lanes, c, center, s);
}

}  // extern "C"
