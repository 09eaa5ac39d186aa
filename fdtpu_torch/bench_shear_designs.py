"""The row shear's designs on one CUDA card: the shipped ``shear_rows``
kernel against the designs it was chosen over.

    python -m fdtpu_torch.bench_shear_designs [--iters 50] [--seed 0]

Builds ``kernels/csrc/designs/shear_rows_designs.cu`` (which includes the
shipped ``csrc/rotate_shear.cu``) into a library of its own under
``build/fdtpu_torch/``, and runs every design on the planes the training
path gives the row shear: K4's horizontal pass (channels stacked on rows,
``c = 1``, ``row_mod = Hp``) and K3a's first pass (NHWC-interleaved lanes,
``c = 3``), on the 26-image exact-k subset at b128/320 in bfloat16 and all
8 images at b8/480 in float32, angles drawn from ``--seed``. Each design is
first held bit-equal to the plain version (``shear_rows_reference``); then
each, and a ``Tensor.copy_`` of the same planes (the same bytes with no
arithmetic), is timed on the card alone, in turns (every design in order,
then in the reverse order), and the two runs are averaged. The bound is
the planes' bytes read once and written once over 3.35 TB/s (the H100
SXM's memory rate; the 8 operations an element take far less over its 67
TFLOP/s of float32).

Also printed for each design: registers and local (stack or spill) bytes a
thread, threads and static shared bytes a CTA and resident CTAs an SM
(``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and from them the most
input bytes a design can have in flight an SM. Prints one line a design
and shape, then one JSON line with the card's nvidia-smi name and power
limit. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from fdtpu_torch.bench_pool_fusion import card_line
from fdtpu_torch.kernels import rotate as krot

SOURCE = Path(__file__).resolve().parent / "kernels" / "csrc" / "designs" / "shear_rows_designs.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9  # H100 SXM: 67 TFLOP/s float32 outside the tensor cores
SHEAR_OPS = 4  # (1 - f) a + f b, per element
SLOT_VECS, SHUFFLE_VECS = 66, 34  # 16-byte vectors a staged step, a shuffle step
SHIPPED, SHUFFLE, RING, BULK = 0, 1, 2, 3
# (name, design, stages, run)
DESIGNS = (
    ("shipped", SHIPPED, 1, 1),
    ("shuffle", SHUFFLE, 1, 1),
    ("ring 1x1", RING, 1, 1),
    ("ring 2x2", RING, 2, 2),
    ("ring 2x8", RING, 2, 8),
    ("ring 4x8", RING, 4, 8),
    ("ring 8x8", RING, 8, 8),
    ("bulk 1x1", BULK, 1, 1),
    ("bulk 2x2", BULK, 2, 2),
    ("bulk 2x8", BULK, 2, 8),
    ("bulk 4x8", BULK, 4, 8),
    ("bulk 8x8", BULK, 8, 8),
)


def build() -> Path:
    """The designs' library, compiled with the port's flags unless the one
    for these sources exists."""
    from fdtpu_torch.kernels import build as kbuild

    digest = hashlib.sha256(" ".join(kbuild.NVCC_FLAGS).encode())
    for src in (SOURCE, kbuild.CSRC / "rotate_shear.cu"):
        digest.update(src.read_bytes())
    out = kbuild.BUILD_DIR / f"libfdtpu_shear_designs_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-shared", str(SOURCE),
                               "-o", lib], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fdtpu_shear_rows_design.argtypes = [i, i, i, p, p, p, i, i, i, i, i, i, f, p]
    lib.fdtpu_shear_rows_design.restype = i
    lib.fdtpu_shear_rows_design_attributes.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.fdtpu_shear_rows_design_attributes.restype = i
    return lib


def cases(seed: int) -> list[tuple]:
    """``(name, planes, k, c, row_mod, center)`` on the card: K4's horizontal
    pass and K3a's first pass at b26/320 bfloat16 and b8/480 float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for b, s, dtype in ((26, 320, torch.bfloat16), (8, 480, torch.float32)):
        x = (torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255).to(dtype)
        ang = (torch.rand((b,), generator=gen, device="cuda") * 2 - 1) * krot.ROTATE_LIMIT_RAD
        padded, _, center, k1, _ = krot._prepare(x, ang)
        hp = padded.shape[1]
        planes = padded.reshape(b, hp, 3 * hp)
        stacked = padded.permute(0, 3, 1, 2).reshape(b, 3 * hp, hp).contiguous()
        out.append(("K4 horizontal", stacked, k1, 1, hp, center))
        out.append(("K3a", planes.contiguous(), k1, 3, 0, center))
    return out


def launcher(lib, design: int, stages: int, run: int, planes, k, c, row_mod, center):
    """A call that launches the design on ``planes`` into one output made
    once; returns the output too."""
    out = torch.empty_like(planes)
    kk, rows, lanes = planes.shape
    stream = torch.cuda.current_stream().cuda_stream
    args = (design, stages, run, planes.data_ptr(), out.data_ptr(), k.data_ptr(),
            int(planes.dtype == torch.bfloat16), kk, rows, lanes, c, row_mod, center, stream)

    def call():
        err = lib.fdtpu_shear_rows_design(*args)
        if err != 0:
            raise RuntimeError(f"design {design} ({stages}, {run}) failed: cudaError {err}")
    return call, out


def device_ms(fn, iters: int) -> float:
    """The card's time for one call of ``fn``, its launches queued behind a
    sleep of about 20 ms so that the card runs them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attributes(lib, design: int, stages: int, run: int, bf16: bool) -> dict:
    vals = (ctypes.c_int * 5)()
    err = lib.fdtpu_shear_rows_design_attributes(design, stages, run, int(bf16), vals)
    if err != 0:
        raise RuntimeError(f"attributes of design {design} failed: cudaError {err}")
    regs, threads, smem, ctas, local = vals
    # input bytes a warp can have in flight: S staged steps, or two shuffle steps
    warp_bytes = 2 * SHUFFLE_VECS * 16 if design == SHUFFLE else stages * SLOT_VECS * 16
    return {"regs": regs, "local_bytes": local, "threads": threads, "smem_bytes": smem,
            "ctas_per_sm": ctas, "in_flight_bytes_per_sm": ctas * threads // 32 * warp_bytes}


def measure(iters: int, seed: int) -> list[dict]:
    lib = load()
    rows = []
    for name, planes, k, c, row_mod, center in cases(seed):
        bf16 = planes.dtype == torch.bfloat16
        want = krot.shear_rows_reference(planes, k, c, row_mod, center)
        calls = {}
        for label, design, stages, run in DESIGNS:
            call, out = launcher(lib, design, stages, run, planes, k, c, row_mod, center)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                err = (out.float() - want.float()).abs().max().item()
                raise RuntimeError(f"{label} differs from the plain version on {name} "
                                   f"{tuple(planes.shape)} {planes.dtype} (max {err})")
            calls[label] = call
        copy = torch.empty_like(planes)
        calls["copy_"] = lambda: copy.copy_(planes)
        runs = {label: [] for label in calls}
        for label in [*calls, *reversed(calls)]:
            runs[label].append(device_ms(calls[label], iters))
        nbytes = 2 * planes.numel() * planes.element_size()
        bound_ms = max(nbytes / HBM_BYTES_PER_MS, SHEAR_OPS * planes.numel() / F32_OPS_PER_MS)
        copy_ms = sum(runs["copy_"]) / 2
        for label, design, stages, run in DESIGNS:
            ms = sum(runs[label]) / 2
            row = {"case": name, "shape": list(planes.shape), "dtype": str(planes.dtype)[6:],
                   "design": label, "ms": ms, "runs_ms": runs[label], "bound_ms": bound_ms,
                   "of_bound": bound_ms / ms, "copy_ms": copy_ms, "of_copy": copy_ms / ms,
                   **attributes(lib, design, stages, run, bf16)}
            rows.append(row)
            print(f"{name} {tuple(planes.shape)} {row['dtype']} {label}: {ms:.5f} ms "
                  f"(runs {runs[label][0]:.5f}/{runs[label][1]:.5f}), {row['of_bound']:.1%} of "
                  f"the bound {bound_ms:.5f}, {row['of_copy']:.1%} of copy_ {copy_ms:.5f} ms; "
                  f"{row['regs']} regs, {row['local_bytes']} B local, {row['threads']} threads, "
                  f"{row['smem_bytes']} B shared, "
                  f"{row['ctas_per_sm']} CTAs/SM, {row['in_flight_bytes_per_sm']} B in flight/SM")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_shear_designs needs a CUDA card")
    card = card_line()
    rows = measure(args.iters, args.seed)
    print(json.dumps({"shear_designs": rows, "iters": args.iters, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0), "card": card}))


if __name__ == "__main__":
    main()
