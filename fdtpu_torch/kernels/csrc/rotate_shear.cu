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
// and writes one, with 8 flops; at 26 x 512 x 1536 bf16 planes a pass must
// move 82 MB (0.0244 ms at 3.35 TB/s).
//
// shear_rows: one CTA per plane row, threads striding along lanes, so loads
// and stores are coalesced (the two taps of neighbouring lanes are
// neighbours too) and each row computes its shift once.
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

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  if constexpr (sizeof(T) * VEC == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&u);
  } else {
    return *reinterpret_cast<const Pack<T, VEC>*>(p);
  }
}

// 16 bytes from device to shared memory without a register, or 16 zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

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

// shear_rows: launch on `stream`, one CTA per plane row. `in`, `out`: (planes, rows,
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
