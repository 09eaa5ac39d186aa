"""Numpy reference interpreter for ``.fdn`` artifacts: the debugging oracle
for the native engine (fdtpu's ``native/reference_interp.py``).

Executes the same op program as ``infer_engine.cpp`` in plain numpy, op by
op, and returns every intermediate activation. With the engine's
``FDN_DEBUG_DIR`` per-op dump hook it shows where the two implementations
diverge (an int8 GEMM edge kernel that indexed rows block-locally was found
this way).

No ML framework and no ctypes: it runs wherever numpy does. Decode and NMS
are not reimplemented (the engine's decode is held against the port's
predict in the tests); the interpreter stops at the final feature map or
the SSD prior buffer.

Format: ``fdtpu_torch/export/native_format.py`` (FDN1 v1/v2).
"""

from __future__ import annotations

import struct

import numpy as np

NO_BIAS = (1 << 64) - 1


def read_fdn(path):
    """Parse header, op records, and the f32 blob."""
    raw = open(path, "rb").read()
    hdr = struct.unpack_from("<7I2fQ", raw, 0)
    assert hdr[0] == int.from_bytes(b"FDN1", "little"), "bad magic"
    n_ops = hdr[2]
    ops, off = [], 44
    for _ in range(n_ops):
        ops.append(struct.unpack_from("<I6ifQQ", raw, off))
        off += 48
    blob = np.frombuffer(raw, np.float32, offset=off)
    return hdr, ops, blob


def _conv_geom(k, st, pad, h, w):
    if pad >= 0:
        return pad, pad, (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
    oh, ow = (h + st - 1) // st, (w + st - 1) // st
    return (max((oh - 1) * st + k - h, 0) // 2,
            max((ow - 1) * st + k - w, 0) // 2, oh, ow)


def _im2col(x, k, st, ph, pw, oh, ow):
    h, w, c = x.shape
    xp = np.zeros((h + 2 * max(ph, k), w + 2 * max(pw, k), c), np.float32)
    xp[ph:ph + h, pw:pw + w] = x
    rows = np.empty((oh, ow, k, k, c), np.float32)
    for dy in range(k):
        for dx in range(k):
            rows[:, :, dy, dx] = xp[dy:dy + oh * st:st,
                                    dx:dx + ow * st:st][:oh, :ow]
    return rows.reshape(oh * ow, k * k * c)


def trace(path: str, img: np.ndarray, quantized: bool = True):
    """Run the op program on one ``(H, W, 3)`` [0, 255] image.

    Returns ``(ops, activations, ssd)`` where ``activations[i]`` is the
    post-op-``i`` tensor (``None`` for DECODE/SSD_HEAD ops) and ``ssd``
    maps prior offsets to head outputs (None for grid models).
    ``quantized=False``
    executes CONV_Q8 ops with dequantized-f32 weights instead of
    simulating the engine's per-row dynamic activation quantization —
    diffing the two isolates quantization error from programming error.
    """
    hdr, ops, blob = read_fdn(path)
    x = (np.asarray(img, np.float32) / 255.0)
    skip = None
    ssd = None
    acts = []
    for (code, p0, p1, p2, p3, p4, p5, f0, woff, boff) in ops:
        if code in (1, 15):  # CONV / CONV_Q8
            k, st, pad, cin, cout, groups = p0, p1, p2, p3, p4, p5
            h, w, _ = x.shape
            ph, pw, oh, ow = _conv_geom(k, st, pad, h, w)
            bias = (blob[boff // 4: boff // 4 + cout]
                    if boff != NO_BIAS else np.float32(0))
            if code == 1 and groups > 1:  # depthwise
                wm = blob[woff // 4: woff // 4 + k * k * cout]
                col = _im2col(x, k, st, ph, pw, oh, ow).reshape(
                    oh * ow, k * k, cout)
                y = np.einsum("mkc,kc->mc", col,
                              wm.reshape(k * k, cout)) + bias
            elif code == 1:
                wm = blob[woff // 4: woff // 4 + k * k * cin * cout]
                y = _im2col(x, k, st, ph, pw, oh, ow) @ wm.reshape(-1, cout)
                y = y + bias
            else:  # CONV_Q8
                K = k * k * cin
                K4 = (K + 3) // 4 * 4
                base = woff // 4
                scales = blob[base: base + cout]
                wsum = blob[base + cout: base + 2 * cout]
                wq = np.frombuffer(
                    blob.tobytes(), np.int8, count=(K4 // 4) * cout * 4,
                    offset=(base + 2 * cout) * 4,
                ).reshape(K4 // 4, cout, 4)
                wmat = np.transpose(wq, (0, 2, 1)).reshape(
                    K4, cout)[:K].astype(np.float32)
                col = _im2col(x, k, st, ph, pw, oh, ow)
                if quantized:
                    lo = np.minimum(col.min(axis=1), 0)
                    hi = np.maximum(col.max(axis=1), 0)
                    # mirror the engine's f32 arithmetic exactly, including
                    # its multiply-by-reciprocal (rint(r*inv), not rint(r/sa)
                    # — they round differently at .5 boundaries)
                    sa = ((hi - lo) / np.float32(255.0)).astype(np.float32)
                    sa = np.where(sa <= 0, np.float32(1.0), sa)
                    inv = (np.float32(1.0) / sa).astype(np.float32)
                    z = np.clip(np.rint(-lo * inv), 0, 255).astype(np.float32)
                    q = np.clip(np.rint(col * inv[:, None]) + z[:, None],
                                0, 255).astype(np.int64)
                    # integer accumulation like the engine's i32 GEMM: a
                    # float matmul loses exactness past 2^24 (K ~ 1000 convs)
                    acc = (q @ wmat.astype(np.int64)).astype(np.float32)
                    y = ((sa[:, None] * scales[None, :]).astype(np.float32)
                         * (acc - (z[:, None] * wsum[None, :]).astype(
                             np.float32)) + bias)
                else:
                    y = col @ (wmat * scales[None, :]) + bias
            x = y.reshape(oh, ow, cout).astype(np.float32)
        elif code == 2:  # LEAKY
            x = np.where(x < 0, f0 * x, x)
        elif code == 3:  # MAXPOOL2
            oh, ow = x.shape[0] // 2, x.shape[1] // 2
            x = x[:oh * 2, :ow * 2].reshape(oh, 2, ow, 2, -1).max(axis=(1, 3))
        elif code == 4:  # SIGMOID
            x = 1.0 / (1.0 + np.exp(-x))
        elif code == 5:  # PUSH
            skip = x.copy()
        elif code == 6:  # ADDSKIP
            x = x + skip
        elif code == 14:  # PUSH_PROJ: skip = conv1x1(x), x untouched
            cin, cout = p3, p4
            h, w, _ = x.shape
            wm = blob[woff // 4: woff // 4 + cin * cout].reshape(cin, cout)
            bias = (blob[boff // 4: boff // 4 + cout]
                    if boff != NO_BIAS else np.float32(0))
            skip = (x.reshape(-1, cin) @ wm + bias).reshape(h, w, cout)
        elif code == 8:  # TRANSPOSE_GRID
            x = np.transpose(x, (1, 0, 2))
        elif code == 9:  # RELU
            x = np.maximum(x, 0)
        elif code == 10:  # HARDSWISH
            x = x * np.clip(x + 3.0, 0, 6) / 6.0
        elif code == 11:  # SE
            C, R = p0, p1
            base = woff // 4
            w1 = blob[base: base + C * R].reshape(C, R)
            b1 = blob[base + C * R: base + C * R + R]
            w2 = blob[base + C * R + R:
                      base + C * R + R + R * C].reshape(R, C)
            b2 = blob[base + C * R + R + R * C:
                      base + C * R + R + R * C + C]
            sv = x.mean(axis=(0, 1))
            t = np.maximum(sv @ w1 + b1, 0)
            g = np.clip(t @ w2 + b2 + 3.0, 0, 6) / 6.0
            x = x * g
        elif code == 12:  # SSD_HEAD
            cin, prior_off, npix = p0, p1, p2
            wm = blob[woff // 4: woff // 4 + cin * 5].reshape(cin, 5)
            bias = blob[boff // 4: boff // 4 + 5]
            z = x.reshape(-1, cin) @ wm + bias
            z[:, 0] = 1.0 / (1.0 + np.exp(-z[:, 0]))
            if ssd is None:
                ssd = {}
            ssd[prior_off] = z
            acts.append(None)
            continue
        elif code in (7, 13):  # DECODE ops — engine-side, not re-implemented
            acts.append(None)
            continue
        acts.append(x.copy())
    return ops, acts, ssd
