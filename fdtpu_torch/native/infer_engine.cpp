// fdtpu_torch's native inference engine (a copy of the JAX package's, built
// and loaded by the port on its own): executes .fdn artifacts (the full
// model zoo — grid detectors incl. MobileNetV3 with BatchNorm folded at
// export, and SSD with multi-scale heads + prior decode) with no Python ML
// framework at serving time — the counterpart of the reference's
// lite-interpreter / onnxruntime deployment path
// (demo_scripts/convert_checkpoint_to_scripted_model.py:51-54,
//  demo_model_onnx.py:26-31).
//
// Format + op codes: fdtpu_torch/export/native_format.py (FDN1). Everything
// is f32 NHWC. The decode+filter+NMS matches fdtpu_torch.core.nms / torchvision
// semantics exactly: strict > threshold, descending-score order with
// lowest-index tie-break (stable sort), xyxy rounded half-to-even
// (nearbyintf under the default FE_TONEAREST, like jnp.round/torch.round),
// suppression strictly above the IoU threshold, boxes emitted compacted in
// pick order (the ragged torchvision return, datasets/utils.py:157-170).
//
// Convolutions run as im2col + a register-blocked SAXPY-style GEMM that GCC
// auto-vectorizes (AVX2/FMA where the CPU has them); depthwise convs take a direct
// channel-vectorized path. Batch images are distributed over a thread pool
// (one image per task).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x314E4446u;  // "FDN1"
constexpr uint64_t kNoBias = ~0ull;

enum OpCode : uint32_t {
  OP_CONV = 1,
  OP_LEAKY = 2,
  OP_MAXPOOL2 = 3,
  OP_SIGMOID = 4,
  OP_PUSH = 5,
  OP_ADDSKIP = 6,
  OP_DECODE_NMS = 7,
  OP_TRANSPOSE_GRID = 8,  // swap the (S, S) axes of the (S, S, C) map
  OP_RELU = 9,
  OP_HARDSWISH = 10,      // x * relu6(x + 3) / 6
  OP_SE = 11,             // squeeze-excite gate (p: channels, reduced)
  OP_SSD_HEAD = 12,       // Dense(cin->5) into the prior buffer
  OP_SSD_DECODE_NMS = 13, // prior decode + pixel scale + greedy NMS
  OP_PUSH_PROJ = 14,      // skip = conv1x1(x) (SSD channel projection)
  OP_CONV_Q8 = 15,        // conv with int8 weights, dynamic u8 activations
};

// The int8 kernel needs AVX512BW (vpmaddubsw/vpmaddwd); without it the
// loader dequantizes OP_CONV_Q8 weights to f32 once and rewrites the op to
// OP_CONV — quantized artifacts stay 4x smaller on disk everywhere, the
// compute win is AVX-512-only.
#if defined(__AVX512BW__)
constexpr bool kHasQ8 = true;
#else
constexpr bool kHasQ8 = false;
#endif

// A conv pad slot of -1 means TF-style SAME (asymmetric, more at the end),
// the tf_mobilenetv3 semantics (fdtpu_torch/models/mobilenetv3.py).
void conv_geometry(int k, int st, int pad, int in_h, int in_w, int* ph,
                   int* pw, int* oh, int* ow) {
  if (pad >= 0) {
    *ph = *pw = pad;
    *oh = (in_h + 2 * pad - k) / st + 1;
    *ow = (in_w + 2 * pad - k) / st + 1;
  } else {
    *oh = (in_h + st - 1) / st;
    *ow = (in_w + st - 1) / st;
    *ph = std::max((*oh - 1) * st + k - in_h, 0) / 2;
    *pw = std::max((*ow - 1) * st + k - in_w, 0) / 2;
  }
}

struct Op {
  uint32_t code;
  int32_t p[6];  // conv: k, stride, pad, cin, cout, groups
  float f0;      // leaky slope
  uint64_t woff, boff;
};

struct Model {
  uint32_t n_ops, in_h, in_w, grid_s, capacity;
  float prob_thr, iou_thr;
  std::vector<Op> ops;
  std::vector<float> blob;
  // scratch sizing (exact walk)
  size_t act_elems = 0, col_elems = 0, ssd_elems = 0;
  size_t qcol_elems = 0, qacc_elems = 0, qrows = 0;  // int8-conv bufs
};

struct Tensor {
  int h = 0, w = 0, c = 0;
  float* d = nullptr;  // borrowed from scratch
};

// Per-thread scratch: two activation buffers + skip + im2col matrix +
// the SSD prior buffer (sum ps^2 x 5 encoded rows) + the int8 path's
// quantized input image and quantized im2col matrix.
struct Scratch {
  std::vector<float> a, b, skip, col, ssd;
  std::vector<uint8_t> qcol;
  std::vector<int32_t> qacc;
  std::vector<float> qrow_scale;
  std::vector<int32_t> qrow_zero;
  explicit Scratch(const Model& m) {
    a.resize(m.act_elems);
    b.resize(m.act_elems);
    skip.resize(m.act_elems);
    col.resize(m.col_elems);
    ssd.resize(m.ssd_elems);
    qcol.resize(m.qcol_elems);
    qacc.resize(m.qacc_elems);
    qrow_scale.resize(m.qrows);
    qrow_zero.resize(m.qrows);
  }
};

// Validate every op record against the header shapes and the actual blob
// BEFORE anything indexes m.blob: fdn_serve takes arbitrary model paths, so
// a truncated or corrupted .fdn must fail to load instead of reading out of
// bounds. Walks the same shape chain as the
// scratch sizing below and checks each weight/bias offset is 4-aligned and
// its expected element count fits the blob.
bool validate_model(const Model& m) {
  const size_t nblob = m.blob.size();  // f32 elements
  auto fits = [&](uint64_t off, size_t f32_elems) {
    return off % 4 == 0 && off / 4 <= nblob && f32_elems <= nblob - off / 4;
  };
  if (m.in_h < 1 || m.in_w < 1 || m.in_h > (1u << 14) || m.in_w > (1u << 14))
    return false;
  if (m.capacity < 1 || m.capacity > (1u << 20)) return false;
  int h = (int)m.in_h, w = (int)m.in_w, c = 3;
  size_t ssd_rows = 0;  // prior-buffer extent established by SSD_HEAD ops
  for (const auto& op : m.ops) {
    const int k = op.p[0], st = op.p[1], pad = op.p[2], cin = op.p[3],
              cout = op.p[4], groups = op.p[5];
    switch (op.code) {
      case OP_CONV:
      case OP_CONV_Q8:
      case OP_PUSH_PROJ: {
        if (k < 1 || k > 64 || st < 1 || st > 64 || pad < -1 || cin != c ||
            cout < 1 || cout > (1 << 16) || groups < 1 || cin % groups != 0)
          return false;
        // the depthwise path assumes groups == cin == cout; Q8 and the
        // skip projection are dense only
        if (groups > 1 && (op.code != OP_CONV || groups != cin ||
                           cin != cout))
          return false;
        if (op.code == OP_PUSH_PROJ && k != 1) return false;
        int ph, pw, oh, ow;
        conv_geometry(k, st, pad, h, w, &ph, &pw, &oh, &ow);
        if (oh < 1 || ow < 1) return false;
        const size_t K = (size_t)k * k * (cin / groups);
        if (op.code == OP_CONV_Q8) {
          const size_t K4 = (K + 3) / 4 * 4;
          // scales (cout) + wsum (cout) f32, then K4*cout int8 bytes
          if (!fits(op.woff, 2 * (size_t)cout + (K4 * cout + 3) / 4))
            return false;
        } else if (!fits(op.woff, K * cout)) {
          return false;
        }
        if (op.boff != kNoBias && !fits(op.boff, cout)) return false;
        if (op.code != OP_PUSH_PROJ) {
          h = oh;
          w = ow;
          c = cout;
        }
        break;
      }
      case OP_MAXPOOL2:
        h /= 2;
        w /= 2;
        if (h < 1 || w < 1) return false;
        break;
      case OP_SE: {
        const int C = op.p[0], R = op.p[1];
        if (C != c || R < 1 ||
            !fits(op.woff, 2 * (size_t)C * R + R + C))
          return false;
        break;
      }
      case OP_SSD_HEAD: {
        const int hc = op.p[0], prior_off = op.p[1], npix = op.p[2];
        if (hc != c || prior_off < 0 || npix != h * w ||
            !fits(op.woff, (size_t)hc * 5) ||
            (op.boff == kNoBias || !fits(op.boff, 5)))
          return false;
        ssd_rows = std::max(ssd_rows, (size_t)prior_off + npix);
        break;
      }
      case OP_SSD_DECODE_NMS: {
        const int n_scales = op.p[0];
        if (n_scales < 1 || n_scales > 5) return false;
        size_t total = 0;
        for (int si = 0; si < n_scales; ++si) {
          if (op.p[1 + si] < 1) return false;
          total += (size_t)op.p[1 + si] * op.p[1 + si];
        }
        if (total > ssd_rows) return false;  // decode past the head writes
        break;
      }
      case OP_TRANSPOSE_GRID:
        if (h != w) return false;
        break;
      case OP_DECODE_NMS:
        if (h != (int)m.grid_s || w != (int)m.grid_s || c != 5) return false;
        break;
      case OP_LEAKY:
      case OP_SIGMOID:
      case OP_PUSH:
      case OP_ADDSKIP:
      case OP_RELU:
      case OP_HARDSWISH:
        break;
      default:
        return false;  // unknown op code
    }
  }
  return true;
}

bool read_model(const char* path, Model* m) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint32_t head_u[7];
  float head_f[2];
  uint64_t blob_bytes;
  if (fread(head_u, 4, 7, f) != 7 || fread(head_f, 4, 2, f) != 2 ||
      fread(&blob_bytes, 8, 1, f) != 1 || head_u[0] != kMagic ||
      head_u[1] < 1 || head_u[1] > 2) {
    fclose(f);
    return false;
  }
  // Cap n_ops/blob_bytes against the actual file size before allocating:
  // the format is exactly header + n_ops records + blob.
  {
    long data_start = ftell(f);
    if (data_start < 0 || fseek(f, 0, SEEK_END) != 0) {
      fclose(f);
      return false;
    }
    long fsz = ftell(f);
    if (fsz < 0 || blob_bytes % 4 != 0 ||
        (uint64_t)fsz !=
            (uint64_t)data_start + (uint64_t)head_u[2] * 48 + blob_bytes ||
        fseek(f, data_start, SEEK_SET) != 0) {
      fclose(f);
      return false;
    }
  }
  m->n_ops = head_u[2];
  m->in_h = head_u[3];
  m->in_w = head_u[4];
  m->grid_s = head_u[5];
  m->capacity = head_u[6];
  m->prob_thr = head_f[0];
  m->iou_thr = head_f[1];
  m->ops.resize(m->n_ops);
  for (auto& op : m->ops) {
    if (fread(&op.code, 4, 1, f) != 1 || fread(op.p, 4, 6, f) != 6 ||
        fread(&op.f0, 4, 1, f) != 1 || fread(&op.woff, 8, 1, f) != 1 ||
        fread(&op.boff, 8, 1, f) != 1) {
      fclose(f);
      return false;
    }
  }
  m->blob.resize(blob_bytes / 4);
  if (blob_bytes && fread(m->blob.data(), 1, blob_bytes, f) != blob_bytes) {
    fclose(f);
    return false;
  }
  fclose(f);

  if (!validate_model(*m)) return false;

  // Without the AVX-512 int8 kernel, dequantize OP_CONV_Q8 weights to f32
  // once (appended to the blob) and rewrite them to plain OP_CONV.
  if (!kHasQ8) {
    for (auto& op : m->ops) {
      if (op.code != OP_CONV_Q8) continue;
      int K = op.p[0] * op.p[0] * op.p[3], cout = op.p[4];
      int K4 = (K + 3) / 4 * 4;
      size_t base = op.woff / 4;
      std::vector<float> scales(m->blob.begin() + base,
                                m->blob.begin() + base + cout);
      // copy the packed int8 bytes BEFORE resize(): the resize reallocates
      // the blob and would leave wq dangling
      const int8_t* wq_src =
          reinterpret_cast<const int8_t*>(m->blob.data() + base + 2 * cout);
      std::vector<int8_t> wq(wq_src, wq_src + (size_t)K4 * cout);
      size_t woff_new = m->blob.size() * 4;
      m->blob.resize(m->blob.size() + (size_t)K * cout);
      float* wm = m->blob.data() + woff_new / 4;
      for (int kk = 0; kk < K; ++kk)
        for (int cc = 0; cc < cout; ++cc)
          wm[(size_t)kk * cout + cc] =
              (float)wq[((size_t)(kk / 4) * cout + cc) * 4 + kk % 4] *
              scales[cc];
      op.code = OP_CONV;
      op.woff = woff_new;
    }
  }

  // Walk shapes once to size scratch buffers exactly.
  int h = m->in_h, w = m->in_w, c = 3;
  m->act_elems = (size_t)h * w * c;
  m->col_elems = 1;
  m->ssd_elems = 0;
  for (const auto& op : m->ops) {
    if (op.code == OP_CONV || op.code == OP_CONV_Q8) {
      int k = op.p[0], s = op.p[1], p = op.p[2], cout = op.p[4],
          groups = op.p[5];
      int ph, pw, oh, ow;
      conv_geometry(k, s, p, h, w, &ph, &pw, &oh, &ow);
      if (op.code == OP_CONV_Q8) {
        int K4 = (k * k * c + 3) / 4 * 4;
        m->col_elems =
            std::max(m->col_elems, (size_t)oh * ow * k * k * c);
        m->qcol_elems = std::max(m->qcol_elems, (size_t)oh * ow * K4);
        m->qacc_elems = std::max(m->qacc_elems, (size_t)oh * ow * cout);
        m->qrows = std::max(m->qrows, (size_t)oh * ow);
      } else if (groups == 1) {
        m->col_elems =
            std::max(m->col_elems, (size_t)oh * ow * k * k * c);
      }
      h = oh;
      w = ow;
      c = cout;
      m->act_elems = std::max(m->act_elems, (size_t)h * w * c);
    } else if (op.code == OP_MAXPOOL2) {
      h /= 2;
      w /= 2;
    } else if (op.code == OP_SSD_HEAD) {
      m->ssd_elems = std::max(
          m->ssd_elems, ((size_t)op.p[1] + op.p[2]) * 5);
    }
    // OP_PUSH_PROJ writes h*w*cout into the skip buffer; its cout equals
    // the block's conv cout, already covered by act_elems.
  }
  return true;
}

// Generic edge kernel: any mr/nr tile, bias fused into the init.
void gemm_edge(const float* col, const float* wm, const float* bias,
               float* out, int i0, int mr, int n0, int nr, int K, int N) {
  for (int i = 0; i < mr; ++i) {
    float* __restrict o = out + (size_t)(i0 + i) * N + n0;
    const float* __restrict ai = col + (size_t)(i0 + i) * K;
    for (int n = 0; n < nr; ++n) o[n] = bias ? bias[n0 + n] : 0.0f;
    for (int kk = 0; kk < K; ++kk) {
      float av = ai[kk];
      const float* __restrict wr = wm + (size_t)kk * N + n0;
      for (int n = 0; n < nr; ++n) o[n] += av * wr[n];
    }
  }
}

// out(oh*ow, cout) = col(oh*ow, K) x w(K, cout).
// Micro-kernel: 6x32 with the K loop unrolled by 2 — 12 zmm accumulators
// live across K (measured faster than a 4x16 register block on an AVX-512
// host). AVX-512 when available; scalar edge fallback.
#if defined(__AVX512F__)
#include <immintrin.h>
void gemm_colmajor_rhs(const float* col, const float* wm, const float* bias,
                       float* out, int M, int K, int N) {
  constexpr int MR = 6, NR = 32;
  int Mmain = M - M % MR, Nmain = N - N % NR;
  for (int i0 = 0; i0 < Mmain; i0 += MR) {
    const float* a = col + (size_t)i0 * K;
    for (int n0 = 0; n0 < Nmain; n0 += NR) {
      __m512 acc0[MR], acc1[MR];
      for (int i = 0; i < MR; ++i) {
        acc0[i] = _mm512_setzero_ps();
        acc1[i] = _mm512_setzero_ps();
      }
      const float* wp = wm + n0;
      int kk = 0;
      for (; kk + 2 <= K; kk += 2) {
        __m512 w0 = _mm512_loadu_ps(wp + (size_t)kk * N);
        __m512 w1 = _mm512_loadu_ps(wp + (size_t)kk * N + 16);
        __m512 u0 = _mm512_loadu_ps(wp + (size_t)(kk + 1) * N);
        __m512 u1 = _mm512_loadu_ps(wp + (size_t)(kk + 1) * N + 16);
        for (int i = 0; i < MR; ++i) {
          __m512 av = _mm512_set1_ps(a[(size_t)i * K + kk]);
          __m512 bv = _mm512_set1_ps(a[(size_t)i * K + kk + 1]);
          acc0[i] = _mm512_fmadd_ps(av, w0, acc0[i]);
          acc1[i] = _mm512_fmadd_ps(av, w1, acc1[i]);
          acc0[i] = _mm512_fmadd_ps(bv, u0, acc0[i]);
          acc1[i] = _mm512_fmadd_ps(bv, u1, acc1[i]);
        }
      }
      for (; kk < K; ++kk) {
        __m512 w0 = _mm512_loadu_ps(wp + (size_t)kk * N);
        __m512 w1 = _mm512_loadu_ps(wp + (size_t)kk * N + 16);
        for (int i = 0; i < MR; ++i) {
          __m512 av = _mm512_set1_ps(a[(size_t)i * K + kk]);
          acc0[i] = _mm512_fmadd_ps(av, w0, acc0[i]);
          acc1[i] = _mm512_fmadd_ps(av, w1, acc1[i]);
        }
      }
      for (int i = 0; i < MR; ++i) {
        float* o = out + (size_t)(i0 + i) * N + n0;
        __m512 b0 = bias ? _mm512_loadu_ps(bias + n0) : _mm512_setzero_ps();
        __m512 b1 =
            bias ? _mm512_loadu_ps(bias + n0 + 16) : _mm512_setzero_ps();
        _mm512_storeu_ps(o, _mm512_add_ps(acc0[i], b0));
        _mm512_storeu_ps(o + 16, _mm512_add_ps(acc1[i], b1));
      }
    }
    if (Nmain < N)
      gemm_edge(col, wm, bias, out, i0, MR, Nmain, N - Nmain, K, N);
  }
  if (Mmain < M)
    gemm_edge(col, wm, bias, out, Mmain, M - Mmain, 0, N, K, N);
}
#else
// Portable register-blocked 4x16 (GCC auto-vectorizes to AVX2/NEON).
void gemm_colmajor_rhs(const float* col, const float* wm, const float* bias,
                       float* out, int M, int K, int N) {
  constexpr int MR = 4, NR = 16;
  int Mmain = M - M % MR, Nmain = N - N % NR;
  for (int i0 = 0; i0 < Mmain; i0 += MR) {
    for (int n0 = 0; n0 < Nmain; n0 += NR) {
      float acc[MR][NR] = {};
      const float* __restrict a0 = col + (size_t)i0 * K;
      const float* __restrict a1 = a0 + K;
      const float* __restrict a2 = a1 + K;
      const float* __restrict a3 = a2 + K;
      const float* __restrict wp = wm + n0;
      for (int kk = 0; kk < K; ++kk) {
        const float* __restrict wr = wp + (size_t)kk * N;
        float v0 = a0[kk], v1 = a1[kk], v2 = a2[kk], v3 = a3[kk];
        for (int n = 0; n < NR; ++n) {
          float w = wr[n];
          acc[0][n] += v0 * w;
          acc[1][n] += v1 * w;
          acc[2][n] += v2 * w;
          acc[3][n] += v3 * w;
        }
      }
      for (int i = 0; i < MR; ++i) {
        float* __restrict o = out + (size_t)(i0 + i) * N + n0;
        if (bias)
          for (int n = 0; n < NR; ++n) o[n] = acc[i][n] + bias[n0 + n];
        else
          for (int n = 0; n < NR; ++n) o[n] = acc[i][n];
      }
    }
    if (Nmain < N)
      gemm_edge(col, wm, bias, out, i0, MR, Nmain, N - Nmain, K, N);
  }
  if (Mmain < M)
    gemm_edge(col, wm, bias, out, Mmain, M - Mmain, 0, N, K, N);
}
#endif

// Zero-padded im2col: rows = output pixels, each row the K = k*k*cin
// receptive-field window, channel-fastest.
void im2col_f32(const Tensor& in, int k, int st, int ph, int pw, int oh,
                int ow, float* col) {
  int K = k * k * in.c;
  for (int oy = 0; oy < oh; ++oy) {
    for (int ox = 0; ox < ow; ++ox) {
      float* dst = col + ((size_t)oy * ow + ox) * K;
      for (int dy = 0; dy < k; ++dy) {
        int iy = oy * st - ph + dy;
        if (iy < 0 || iy >= in.h) {
          std::memset(dst, 0, (size_t)k * in.c * sizeof(float));
          dst += (size_t)k * in.c;
          continue;
        }
        for (int dx = 0; dx < k; ++dx) {
          int ix = ox * st - pw + dx;
          if (ix < 0 || ix >= in.w) {
            std::memset(dst, 0, in.c * sizeof(float));
          } else {
            std::memcpy(dst, in.d + ((size_t)iy * in.w + ix) * in.c,
                        in.c * sizeof(float));
          }
          dst += in.c;
        }
      }
    }
  }
}

void conv(const Model& m, const Op& op, const Tensor& in, Tensor* out,
          Scratch* s) {
  int k = op.p[0], st = op.p[1], cout = op.p[4], groups = op.p[5];
  int ph, pw, oh, ow;
  conv_geometry(k, st, op.p[2], in.h, in.w, &ph, &pw, &oh, &ow);
  out->h = oh;
  out->w = ow;
  out->c = cout;
  const float* wm = m.blob.data() + op.woff / 4;
  const float* bias =
      op.boff == kNoBias ? nullptr : m.blob.data() + op.boff / 4;

  if (groups > 1) {  // depthwise: groups == cin == cout, w (k*k, c)
    for (int oy = 0; oy < oh; ++oy) {
      for (int ox = 0; ox < ow; ++ox) {
        float* __restrict o = out->d + ((size_t)oy * ow + ox) * cout;
        if (bias)
          std::memcpy(o, bias, cout * sizeof(float));
        else
          std::memset(o, 0, cout * sizeof(float));
        for (int dy = 0; dy < k; ++dy) {
          int iy = oy * st - ph + dy;
          if (iy < 0 || iy >= in.h) continue;
          for (int dx = 0; dx < k; ++dx) {
            int ix = ox * st - pw + dx;
            if (ix < 0 || ix >= in.w) continue;
            const float* __restrict iv =
                in.d + ((size_t)iy * in.w + ix) * cout;
            const float* __restrict wr = wm + (size_t)(dy * k + dx) * cout;
            for (int c = 0; c < cout; ++c) o[c] += iv[c] * wr[c];
          }
        }
      }
    }
    return;
  }

  int K = k * k * in.c;
  float* col = s->col.data();
  im2col_f32(in, k, st, ph, pw, oh, ow, col);
  gemm_colmajor_rhs(col, wm, bias, out->d, oh * ow, K, cout);
}

// ---- int8-weight conv (OP_CONV_Q8) ----------------------------------------
// Weights: per-cout symmetric int8, packed (ceil(K/4), cout, 4) — four
// consecutive K-values per channel dword, the vpmaddubsw operand layout.
// Activations: quantized dynamically per conv to u8 (a_q in [0,255],
// a = (a_q - z) * s_a); the 7-bit weights (|w_q| <= 63) keep the i16
// pair-sum in vpmaddubsw below saturation (255*63*2 < 32767). Output:
//   out[m][c] = s_a * s_w[c] * (acc[m][c] - z * wsum[c]) + bias[c].

// Scalar reference/edge kernel over the packed layout.
void gemm_q8_edge(const uint8_t* qcol, const int8_t* wq, int m0, int mr,
                  int n0, int nr, int K4, int cout, int32_t* acc_out) {
  for (int i = 0; i < mr; ++i) {
    const uint8_t* row = qcol + (size_t)(m0 + i) * K4;
    for (int n = 0; n < nr; ++n) {
      int32_t acc = 0;
      const int8_t* wc = wq + (size_t)(n0 + n) * 4;
      for (int g = 0; g < K4 / 4; ++g) {
        const int8_t* wg = wc + (size_t)g * cout * 4;
        const uint8_t* ag = row + 4 * g;
        acc += (int32_t)ag[0] * wg[0] + (int32_t)ag[1] * wg[1] +
               (int32_t)ag[2] * wg[2] + (int32_t)ag[3] * wg[3];
      }
      acc_out[(size_t)(m0 + i) * cout + n0 + n] = acc;
    }
  }
}

#if defined(__AVX512BW__)
// 4x32 micro-kernel: 8 zmm i32 accumulators, vpmaddubsw (u8 x s8 -> i16
// pairs) + vpmaddwd (i16 -> i32) per 4-K group — 64 MACs per 3 ops/lane.
void gemm_q8(const uint8_t* qcol, const int8_t* wq, int M, int K4, int cout,
             int32_t* acc_out) {
  constexpr int MR = 4, NR = 32;
  const __m512i ones = _mm512_set1_epi16(1);
  int Mmain = M - M % MR, Nmain = cout - cout % NR;
  for (int m0 = 0; m0 < Mmain; m0 += MR) {
    const uint8_t* r0 = qcol + (size_t)m0 * K4;
    const uint8_t* r1 = r0 + K4;
    const uint8_t* r2 = r1 + K4;
    const uint8_t* r3 = r2 + K4;
    for (int n0 = 0; n0 < Nmain; n0 += NR) {
      __m512i acc[MR][2];
      for (int i = 0; i < MR; ++i)
        acc[i][0] = acc[i][1] = _mm512_setzero_si512();
      const int8_t* wp = wq + (size_t)n0 * 4;
      for (int g = 0; g < K4 / 4; ++g) {
        const int8_t* wg = wp + (size_t)g * cout * 4;
        __m512i w0 = _mm512_loadu_si512((const void*)wg);
        __m512i w1 = _mm512_loadu_si512((const void*)(wg + 64));
        __m512i a0 = _mm512_set1_epi32(*(const int32_t*)(r0 + 4 * g));
        __m512i a1 = _mm512_set1_epi32(*(const int32_t*)(r1 + 4 * g));
        __m512i a2 = _mm512_set1_epi32(*(const int32_t*)(r2 + 4 * g));
        __m512i a3 = _mm512_set1_epi32(*(const int32_t*)(r3 + 4 * g));
        acc[0][0] = _mm512_add_epi32(
            acc[0][0],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a0, w0), ones));
        acc[0][1] = _mm512_add_epi32(
            acc[0][1],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a0, w1), ones));
        acc[1][0] = _mm512_add_epi32(
            acc[1][0],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a1, w0), ones));
        acc[1][1] = _mm512_add_epi32(
            acc[1][1],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a1, w1), ones));
        acc[2][0] = _mm512_add_epi32(
            acc[2][0],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a2, w0), ones));
        acc[2][1] = _mm512_add_epi32(
            acc[2][1],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a2, w1), ones));
        acc[3][0] = _mm512_add_epi32(
            acc[3][0],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a3, w0), ones));
        acc[3][1] = _mm512_add_epi32(
            acc[3][1],
            _mm512_madd_epi16(_mm512_maddubs_epi16(a3, w1), ones));
      }
      for (int i = 0; i < MR; ++i) {
        _mm512_storeu_si512(
            (void*)(acc_out + (size_t)(m0 + i) * cout + n0), acc[i][0]);
        _mm512_storeu_si512(
            (void*)(acc_out + (size_t)(m0 + i) * cout + n0 + 16),
            acc[i][1]);
      }
    }
    int n0 = Nmain;
    if (cout - n0 >= 16) {  // one-zmm block: covers MobileNetV3's 24/40/48
      __m512i acc[MR];
      for (int i = 0; i < MR; ++i) acc[i] = _mm512_setzero_si512();
      const int8_t* wp = wq + (size_t)n0 * 4;
      for (int g = 0; g < K4 / 4; ++g) {
        const int8_t* wg = wp + (size_t)g * cout * 4;
        __m512i w0 = _mm512_loadu_si512((const void*)wg);
        __m512i a0 = _mm512_set1_epi32(*(const int32_t*)(r0 + 4 * g));
        __m512i a1 = _mm512_set1_epi32(*(const int32_t*)(r1 + 4 * g));
        __m512i a2 = _mm512_set1_epi32(*(const int32_t*)(r2 + 4 * g));
        __m512i a3 = _mm512_set1_epi32(*(const int32_t*)(r3 + 4 * g));
        acc[0] = _mm512_add_epi32(
            acc[0], _mm512_madd_epi16(_mm512_maddubs_epi16(a0, w0), ones));
        acc[1] = _mm512_add_epi32(
            acc[1], _mm512_madd_epi16(_mm512_maddubs_epi16(a1, w0), ones));
        acc[2] = _mm512_add_epi32(
            acc[2], _mm512_madd_epi16(_mm512_maddubs_epi16(a2, w0), ones));
        acc[3] = _mm512_add_epi32(
            acc[3], _mm512_madd_epi16(_mm512_maddubs_epi16(a3, w0), ones));
      }
      for (int i = 0; i < MR; ++i)
        _mm512_storeu_si512(
            (void*)(acc_out + (size_t)(m0 + i) * cout + n0), acc[i]);
      n0 += 16;
    }
    if (n0 < cout)
      gemm_q8_edge(qcol, wq, m0, MR, n0, cout - n0, K4, cout, acc_out);
  }
  if (Mmain < M)
    gemm_q8_edge(qcol, wq, Mmain, M - Mmain, 0, cout, K4, cout, acc_out);
}
#else
void gemm_q8(const uint8_t* qcol, const int8_t* wq, int M, int K4, int cout,
             int32_t* acc_out) {
  gemm_q8_edge(qcol, wq, 0, M, 0, cout, K4, cout, acc_out);
}
#endif

void conv_q8(const Model& m, const Op& op, const Tensor& in, Tensor* out,
             Scratch* s) {
  int k = op.p[0], st = op.p[1], cout = op.p[4];
  int ph, pw, oh, ow;
  conv_geometry(k, st, op.p[2], in.h, in.w, &ph, &pw, &oh, &ow);
  out->h = oh;
  out->w = ow;
  out->c = cout;
  int K = k * k * in.c, K4 = (K + 3) / 4 * 4;
  size_t base = op.woff / 4;
  const float* scales = m.blob.data() + base;
  const float* wsum = scales + cout;
  const int8_t* wq = reinterpret_cast<const int8_t*>(wsum + cout);
  const float* bias =
      op.boff == kNoBias ? nullptr : m.blob.data() + op.boff / 4;

  // f32 im2col (shared with the f32 conv path), then PER-ROW dynamic u8
  // quantization: each output pixel's K-element receptive field gets its
  // own scale/zero-point. Per-tensor ranges are wrecked by activation
  // outliers in these BatchNorm-free LeakyReLU stacks (measured on the
  // official PoolResnet: per-tensor quantization drifts scores by up to
  // 0.25; per-row is ~1e-2) — locality tames the range. Padding zeros are
  // real zeros in the f32 col, so each row's range includes them.
  // 1x1 convs (the whole MobileNetV3 quantized surface) need no im2col —
  // the input IS the row matrix; skipping the copy trims the per-row
  // quantize overhead that makes int8 marginal on small-K convs
  const float* col = in.d;
  if (k != 1 || st != 1) {
    im2col_f32(in, k, st, ph, pw, oh, ow, s->col.data());
    col = s->col.data();
  }
  int M = oh * ow;
  uint8_t* qcol = s->qcol.data();
  float* s_a = s->qrow_scale.data();
  int32_t* z_a = s->qrow_zero.data();
  for (int i = 0; i < M; ++i) {
    const float* r = col + (size_t)i * K;
    float lo = 0.0f, hi = 0.0f;
    int kk = 0;
#if defined(__AVX512F__)
    {
      __m512 vlo = _mm512_setzero_ps(), vhi = _mm512_setzero_ps();
      for (; kk + 16 <= K; kk += 16) {
        __m512 v = _mm512_loadu_ps(r + kk);
        vlo = _mm512_min_ps(vlo, v);
        vhi = _mm512_max_ps(vhi, v);
      }
      lo = _mm512_reduce_min_ps(vlo);
      hi = _mm512_reduce_max_ps(vhi);
    }
#endif
    for (; kk < K; ++kk) {
      lo = std::min(lo, r[kk]);
      hi = std::max(hi, r[kk]);
    }
    float sa = (hi - lo) / 255.0f;
    if (sa <= 0.0f) sa = 1.0f;
    float inv = 1.0f / sa;
    int z = (int)nearbyintf(-lo * inv);
    z = std::min(std::max(z, 0), 255);
    uint8_t* q = qcol + (size_t)i * K4;
    kk = 0;
#if defined(__AVX512F__)
    {
      __m512 vinv = _mm512_set1_ps(inv);
      __m512i vz = _mm512_set1_epi32(z), zero = _mm512_setzero_si512();
      __m512i v255 = _mm512_set1_epi32(255);
      for (; kk + 16 <= K; kk += 16) {
        // cvtps rounds to nearest-even (default MXCSR), like nearbyintf
        __m512i qi = _mm512_cvtps_epi32(
            _mm512_mul_ps(_mm512_loadu_ps(r + kk), vinv));
        qi = _mm512_min_epi32(
            _mm512_max_epi32(_mm512_add_epi32(qi, vz), zero), v255);
        _mm_storeu_si128((__m128i*)(q + kk), _mm512_cvtepi32_epi8(qi));
      }
    }
#endif
    for (; kk < K; ++kk) {
      int qv = (int)nearbyintf(r[kk] * inv) + z;
      q[kk] = (uint8_t)std::min(std::max(qv, 0), 255);
    }
    for (kk = K; kk < K4; ++kk) q[kk] = 0;  // w == 0 there anyway
    s_a[i] = sa;
    z_a[i] = z;
  }

  // i32 accumulate into scratch, then per-row dequantize + bias
  int32_t* acc = s->qacc.data();
  gemm_q8(qcol, wq, M, K4, cout, acc);
  for (int i = 0; i < M; ++i) {
    float* o = out->d + (size_t)i * cout;
    const int32_t* ar = acc + (size_t)i * cout;
    float sa = s_a[i], zf = (float)z_a[i];
    for (int c2 = 0; c2 < cout; ++c2) {
      float v = sa * scales[c2] * ((float)ar[c2] - zf * wsum[c2]);
      o[c2] = bias ? v + bias[c2] : v;
    }
  }
}

// Greedy suppression over thresholded, rounded xyxy candidates — the exact
// torchvision semantics (descending score, stable tie-break by original
// index, suppress IoU strictly > threshold), boxes emitted compacted in
// pick order as [score, x, y, w, h].
void greedy_nms(const std::vector<float>& score, const std::vector<float>& x0,
                const std::vector<float>& y0, const std::vector<float>& x1,
                const std::vector<float>& y1, std::vector<int>& cand,
                int cap, float iou_thr, float* boxes, unsigned char* mask) {
  // descending score, stable (lowest original index wins ties)
  std::stable_sort(cand.begin(), cand.end(),
                   [&](int a, int b) { return score[a] > score[b]; });
  std::memset(boxes, 0, (size_t)cap * 5 * sizeof(float));
  std::memset(mask, 0, cap);
  std::vector<char> dead(cand.size(), 0);
  int out = 0;
  for (size_t i = 0; i < cand.size() && out < cap; ++i) {
    if (dead[i]) continue;
    int a = cand[i];
    float* row = boxes + (size_t)out * 5;
    row[0] = score[a];
    row[1] = x0[a];
    row[2] = y0[a];
    row[3] = x1[a] - x0[a];
    row[4] = y1[a] - y0[a];
    mask[out++] = 1;
    float aw = std::max(x1[a] - x0[a], 0.0f);
    float ah = std::max(y1[a] - y0[a], 0.0f);
    float area_a = aw * ah;
    for (size_t j = i + 1; j < cand.size(); ++j) {
      if (dead[j]) continue;
      int b = cand[j];
      float ix0 = std::max(x0[a], x0[b]), iy0 = std::max(y0[a], y0[b]);
      float ix1 = std::min(x1[a], x1[b]), iy1 = std::min(y1[a], y1[b]);
      float inter =
          std::max(ix1 - ix0, 0.0f) * std::max(iy1 - iy0, 0.0f);
      float bw = std::max(x1[b] - x0[b], 0.0f);
      float bh = std::max(y1[b] - y0[b], 0.0f);
      float uni = area_a + bw * bh - inter;
      float iou = uni > 0 ? inter / uni : 0.0f;
      if (iou > iou_thr) dead[j] = 1;
    }
  }
}

void decode_nms(const Model& m, const Tensor& fm, float* boxes,
                unsigned char* mask) {
  int S = m.grid_s;
  float W = (float)m.in_w, H = (float)m.in_h;
  float xp = W / S, yp = H / S;
  int n = S * S;
  std::vector<float> score(n), x0(n), y0(n), x1(n), y1(n);
  std::vector<int> cand;
  cand.reserve(n);
  for (int j = 0; j < S; ++j) {
    for (int i = 0; i < S; ++i) {
      const float* v = fm.d + ((size_t)j * S + i) * 5;
      int idx = j * S + i;
      score[idx] = v[0];
      if (v[0] > m.prob_thr) {  // strict >, utils.py:111
        float x = v[1] * xp + i * xp;
        float y = v[2] * yp + j * yp;
        float w = v[3] * W, h = v[4] * H;
        // round like jnp.round/torch.round: half-to-even
        x0[idx] = nearbyintf(x);
        y0[idx] = nearbyintf(y);
        x1[idx] = nearbyintf(x + w);
        y1[idx] = nearbyintf(y + h);
        cand.push_back(idx);
      }
    }
  }
  greedy_nms(score, x0, y0, x1, y1, cand, m.capacity, m.iou_thr, boxes,
             mask);
}

// SSD prior decode (fdtpu_torch/core/priors.py apply_priors, SSD.py:206-220) +
// pixel scaling (utils.py:57-67) + the same exact NMS. The prior buffer
// holds [sigmoid(conf), x_enc, y_enc, w_norm, h_norm] rows; each scale's
// block is flattened row-major over (y_cell, x_cell), the port's prior
// order (fdtpu_torch/core/priors.py).
void decode_nms_ssd(const Model& m, const Op& op, const float* ssd,
                    float* boxes, unsigned char* mask) {
  int n_scales = op.p[0];
  float W = (float)m.in_w, H = (float)m.in_h;
  int total = 0;
  for (int si = 0; si < n_scales; ++si) total += op.p[1 + si] * op.p[1 + si];
  std::vector<float> score(total), x0(total), y0(total), x1(total),
      y1(total);
  std::vector<int> cand;
  cand.reserve(256);
  int off = 0;
  for (int si = 0; si < n_scales; ++si) {
    int ps = op.p[1 + si];
    float inv = 1.0f / ps;
    for (int idx = 0; idx < ps * ps; ++idx) {
      const float* v = ssd + ((size_t)off + idx) * 5;
      score[off + idx] = v[0];
      if (v[0] > m.prob_thr) {
        int yc = idx / ps, xc = idx % ps;
        float x = (v[1] * inv + xc * inv) * W;
        float y = (v[2] * inv + yc * inv) * H;
        float w = v[3] * W, h = v[4] * H;
        x0[off + idx] = nearbyintf(x);
        y0[off + idx] = nearbyintf(y);
        x1[off + idx] = nearbyintf(x + w);
        y1[off + idx] = nearbyintf(y + h);
        cand.push_back(off + idx);
      }
    }
    off += ps * ps;
  }
  greedy_nms(score, x0, y0, x1, y1, cand, m.capacity, m.iou_thr, boxes,
             mask);
}

void debug_dump(int oi, const Tensor& t) {
  const char* dir = getenv("FDN_DEBUG_DIR");
  if (!dir) return;
  char path[512];
  snprintf(path, sizeof path, "%s/op%03d.bin", dir, oi);
  FILE* f = fopen(path, "wb");
  if (!f) return;
  int hdr[3] = {t.h, t.w, t.c};
  fwrite(hdr, 4, 3, f);
  fwrite(t.d, 4, (size_t)t.h * t.w * t.c, f);
  fclose(f);
}

// img_index gates the FDN_DEBUG_DIR dump: per-op filenames are keyed by op
// index only, so with batch > 1 (or multiple threads) every image would
// overwrite the same files — only image 0 dumps.
void run_image(const Model& m, const float* img, float* boxes,
               unsigned char* mask, Scratch* s, int img_index) {
  Tensor cur{(int)m.in_h, (int)m.in_w, 3, s->a.data()};
  Tensor nxt{0, 0, 0, s->b.data()};
  Tensor skip{0, 0, 0, s->skip.data()};
  size_t npix = (size_t)m.in_h * m.in_w * 3;
  for (size_t i = 0; i < npix; ++i) cur.d[i] = img[i] / 255.0f;

  int op_index = -1;
  for (const auto& op : m.ops) {
    ++op_index;
    switch (op.code) {
      case OP_CONV:
        conv(m, op, cur, &nxt, s);
        std::swap(cur.d, nxt.d);
        cur.h = nxt.h;
        cur.w = nxt.w;
        cur.c = nxt.c;
        break;
      case OP_CONV_Q8:
        conv_q8(m, op, cur, &nxt, s);
        std::swap(cur.d, nxt.d);
        cur.h = nxt.h;
        cur.w = nxt.w;
        cur.c = nxt.c;
        break;
      case OP_LEAKY: {
        size_t nn = (size_t)cur.h * cur.w * cur.c;
        float sl = op.f0;
        for (size_t i = 0; i < nn; ++i)
          cur.d[i] = cur.d[i] < 0 ? sl * cur.d[i] : cur.d[i];
        break;
      }
      case OP_MAXPOOL2: {
        int oh = cur.h / 2, ow = cur.w / 2, c = cur.c;
        for (int oy = 0; oy < oh; ++oy)
          for (int ox = 0; ox < ow; ++ox) {
            const float* i00 =
                cur.d + ((size_t)(2 * oy) * cur.w + 2 * ox) * c;
            const float* i01 = i00 + c;
            const float* i10 = i00 + (size_t)cur.w * c;
            const float* i11 = i10 + c;
            float* o = nxt.d + ((size_t)oy * ow + ox) * c;
            for (int ch = 0; ch < c; ++ch)
              o[ch] = std::max(std::max(i00[ch], i01[ch]),
                               std::max(i10[ch], i11[ch]));
          }
        std::swap(cur.d, nxt.d);
        cur.h = oh;
        cur.w = ow;
        break;
      }
      case OP_SIGMOID: {
        size_t nn = (size_t)cur.h * cur.w * cur.c;
        for (size_t i = 0; i < nn; ++i)
          cur.d[i] = 1.0f / (1.0f + std::exp(-cur.d[i]));
        break;
      }
      case OP_PUSH:
        std::memcpy(skip.d, cur.d,
                    (size_t)cur.h * cur.w * cur.c * sizeof(float));
        skip.h = cur.h;
        skip.w = cur.w;
        skip.c = cur.c;
        break;
      case OP_ADDSKIP: {
        size_t nn = (size_t)cur.h * cur.w * cur.c;
        for (size_t i = 0; i < nn; ++i) cur.d[i] += skip.d[i];
        break;
      }
      case OP_TRANSPOSE_GRID: {
        // reference grid convention fm[:, x_cell, y_cell] -> [y, x]
        // (fdtpu_torch/compat ReferenceLayoutGrid)
        int s = cur.h, c = cur.c;
        for (int y = 0; y < s; ++y)
          for (int x = 0; x < s; ++x)
            std::memcpy(nxt.d + ((size_t)y * s + x) * c,
                        cur.d + ((size_t)x * s + y) * c, c * sizeof(float));
        std::swap(cur.d, nxt.d);
        break;
      }
      case OP_DECODE_NMS:
        decode_nms(m, cur, boxes, mask);
        break;
      case OP_RELU: {
        size_t nn = (size_t)cur.h * cur.w * cur.c;
        for (size_t i = 0; i < nn; ++i) cur.d[i] = std::max(cur.d[i], 0.0f);
        break;
      }
      case OP_HARDSWISH: {
        size_t nn = (size_t)cur.h * cur.w * cur.c;
        for (size_t i = 0; i < nn; ++i) {
          float v = cur.d[i];
          cur.d[i] =
              v * std::min(std::max(v + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
        }
        break;
      }
      case OP_SE: {
        // global-avg -> 1x1 reduce (ReLU) -> 1x1 expand (hard-sigmoid)
        // -> per-channel scale (fdtpu_torch/models/mobilenetv3.py SqueezeExcite)
        int C = op.p[0], R = op.p[1];
        const float* w1 = m.blob.data() + op.woff / 4;  // (C, R)
        const float* b1 = w1 + (size_t)C * R;
        const float* w2 = b1 + R;  // (R, C)
        const float* b2 = w2 + (size_t)R * C;
        std::vector<float> sv(C, 0.0f), tv(R);
        size_t npix = (size_t)cur.h * cur.w;
        for (size_t i = 0; i < npix; ++i) {
          const float* px = cur.d + i * C;
          for (int c = 0; c < C; ++c) sv[c] += px[c];
        }
        float scale = 1.0f / (float)npix;
        for (int c = 0; c < C; ++c) sv[c] *= scale;
        for (int r = 0; r < R; ++r) tv[r] = b1[r];
        for (int c = 0; c < C; ++c) {
          float v = sv[c];
          const float* wr = w1 + (size_t)c * R;
          for (int r = 0; r < R; ++r) tv[r] += v * wr[r];
        }
        for (int r = 0; r < R; ++r) tv[r] = std::max(tv[r], 0.0f);
        std::vector<float> gv(C);
        for (int c = 0; c < C; ++c) gv[c] = b2[c];
        for (int r = 0; r < R; ++r) {
          float v = tv[r];
          const float* wr = w2 + (size_t)r * C;
          for (int c = 0; c < C; ++c) gv[c] += v * wr[c];
        }
        for (int c = 0; c < C; ++c)
          gv[c] = std::min(std::max(gv[c] + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
        for (size_t i = 0; i < npix; ++i) {
          float* px = cur.d + i * C;
          for (int c = 0; c < C; ++c) px[c] *= gv[c];
        }
        break;
      }
      case OP_SSD_HEAD: {
        // Dense(cin -> 5) over the row-major (h*w, cin) map into the prior
        // buffer at prior_offset, sigmoid on the score column (SSD.py:240-245)
        int cin = op.p[0], prior_off = op.p[1], npix = op.p[2];
        const float* wm = m.blob.data() + op.woff / 4;
        const float* bias = m.blob.data() + op.boff / 4;
        float* dst = s->ssd.data() + (size_t)prior_off * 5;
        gemm_colmajor_rhs(cur.d, wm, bias, dst, npix, cin, 5);
        for (int i = 0; i < npix; ++i) {
          float* row = dst + (size_t)i * 5;
          row[0] = 1.0f / (1.0f + std::exp(-row[0]));
        }
        break;
      }
      case OP_SSD_DECODE_NMS:
        decode_nms_ssd(m, op, s->ssd.data(), boxes, mask);
        break;
      case OP_PUSH_PROJ: {
        // skip = conv1x1(cur): the SSD block's channel-matching skip
        // projection (SSD.py:30-36); cur is untouched.
        int cout = op.p[4];
        const float* wm = m.blob.data() + op.woff / 4;
        const float* bias =
            op.boff == kNoBias ? nullptr : m.blob.data() + op.boff / 4;
        gemm_colmajor_rhs(cur.d, wm, bias, skip.d, cur.h * cur.w, cur.c,
                          cout);
        skip.h = cur.h;
        skip.w = cur.w;
        skip.c = cout;
        break;
      }
    }
    if (img_index == 0) debug_dump(op_index, cur);
  }
}

}  // namespace

extern "C" {

void* fdn_load(const char* path) {
  auto* m = new Model();
  if (!read_model(path, m)) {
    delete m;
    return nullptr;
  }
  return m;
}

void fdn_free(void* h) { delete static_cast<Model*>(h); }

// Returns 0 on success; fills input height/width and NMS capacity.
int fdn_info(void* h, int* in_h, int* in_w, int* capacity) {
  if (!h) return -1;
  auto* m = static_cast<Model*>(h);
  *in_h = (int)m->in_h;
  *in_w = (int)m->in_w;
  *capacity = (int)m->capacity;
  return 0;
}

// imgs: (batch, in_h, in_w, 3) f32 in [0, 255] (the engine normalizes /255
// like BaseModel.py:66). boxes: (batch, capacity, 5) rows
// [score, x, y, w, h] pixels; mask: (batch, capacity) 0/1.
int fdn_predict(void* h, const float* imgs, int batch, float* boxes,
                unsigned char* mask, int num_threads) {
  if (!h || batch <= 0) return -1;
  auto* m = static_cast<Model*>(h);
  if (num_threads <= 0)
    num_threads = (int)std::thread::hardware_concurrency();
  num_threads = std::max(1, std::min(num_threads, batch));
  size_t img_sz = (size_t)m->in_h * m->in_w * 3;
  size_t box_sz = (size_t)m->capacity * 5;

  auto worker = [&](int t) {
    Scratch s(*m);
    for (int i = t; i < batch; i += num_threads)
      run_image(*m, imgs + i * img_sz, boxes + i * box_sz,
                mask + (size_t)i * m->capacity, &s, i);
  };
  if (num_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < num_threads; ++t) ts.emplace_back(worker, t);
    for (auto& t : ts) t.join();
  }
  return 0;
}

}  // extern "C"
