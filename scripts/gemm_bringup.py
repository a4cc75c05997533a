#!/usr/bin/env python3
"""Bring-up checks and times of the two GEMM kernels on one CUDA card.

    python3 scripts/gemm_bringup.py [--no-variants]

1. Builds block_matmul and fused_dense from src/repro_torch/kernels/csrc
   and prints ptxas's registers, spills and shared memory per instance.
2. Both kernels against their plain versions at the main paths' shapes
   (block_matmul 1320x4096 @ 4096x2048 over 16 weight tiles, fused_dense
   1,742,400x256 @ 256x256 + b; weights scaled by K^-0.5 as the models'
   are), at K = 4096 with N(0,1) weights, and at shapes whose rows or
   pointers are not 16-byte aligned (the element-copy instance); f32 at
   rtol = atol = 1e-4, bf16 at 3e-2. Prints the largest |err| over the bar
   (atol + rtol |want|): below 1 passes. The main block_matmul shape with
   N(0,1) weights is held against the float64 product, with the kernel's and
   the plain version's ratios to it and to each other printed.
3. Their times at the main shapes beside torch.matmul / torch.addmm (CUDA
   events, mean of 20 calls), with TFLOP/s and the share of the 3xTF32
   tensor-core bound (3 x 2MNK at the dense TF32 peak, or bytes at HBM rate).
4. Variants of csrc/tc_gemm.cuh, built under build/variants/ with one part
   changed each and timed as in 3 in two rounds: four f32 stages (checked at
   the main shape and at 65x4096x130 with N(0,1) weights), and, timed only,
   one TF32 product instead of three, no split pass over x's slice, no
   stores of the result, and no loads into shared memory (their results are
   wrong by construction).

The kernels' parity at every test shape is tests/test_torch_kernels_cuda.py's
and chip_smoke.py's; the tensor-core check of their SASS is chip_smoke.py's.
Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref  # noqa: E402
from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref  # noqa: E402

HBM = 3.35e12  # H100 SXM data sheet, bytes/s
TF32_PEAK = 494.7e12  # dense TF32 tensor-core FLOP/s, SXM
F32_TOL, BF16_TOL = 1e-4, 3e-2
BM_MAIN = (1320, 4096, 2048, 16)  # rec_q3 at scale 20: the autoencoder's layer 1
FD_MAIN = (1320 * 1320, 256, 256)  # rec_q3 at scale 20: cos_sim's towers

# variants of csrc/tc_gemm.cuh, as (text, replacement); those marked
# unchecked compute something else on purpose and are only timed
VARIANTS = {
    "kernel": [],
    "f32 4 stages": [("namespace tf32 {\nconstexpr int STAGES = 3;",
                      "namespace tf32 {\nconstexpr int STAGES = 4;")],
    "one TF32 product (unchecked)": [
        ("""      wgmma_tf32_n64(part, al + 4 * ks, dh, ks > 0);
      wgmma_tf32_n64(part, ah + 4 * ks, dl, 1);
      wgmma_tf32_n64(part, ah + 4 * ks, dh, 1);""",
         "      wgmma_tf32_n64(part, ah + 4 * ks, dh, ks > 0);")],
    "no x split pass (unchecked)": [
        ("    for (int j = 0; j < X_BYTES / 16 / THREADS; ++j) {",
         "    for (int j = 0; j < 0; ++j) {")],
    "no stores (unchecked)": [
        ("      if (m < M && n < n_end) out[(size_t)m * N + n]",
         "      if (m < M && n < n_end && acc[4 * j + e] == 1e-38f) out[(size_t)m * N + n]")],
    "no loads (unchecked)": [
        ("      if constexpr (VEC) hop::cp_async16(dst, src, ok);",
         "      if constexpr (VEC) (void)src;"),
        ("    if constexpr (VEC) hop::cp_async16(hop::smem_u32(dst + r * LD + c), s, ok);",
         "    if constexpr (VEC) (void)s;")],
}


def normal(shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, device="cuda") * scale).to(dtype)


def events_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ratio(got, want, tol):
    """The largest |err| / (tol + tol |want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def check(label, got, want, tol) -> int:
    r = ratio(got, want, tol)
    err = float((got.double() - want.double()).abs().max())
    print(f"[parity] {'ok' if r <= 1 else 'FAIL'} {label}: max|err|={err:.3g}, "
          f"largest |err| / bar = {r:.4f} (bar rtol=atol={tol:g})")
    return 0 if r <= 1 else 1


def check_all() -> int:
    bad = 0
    m, k, n, t = BM_MAIN
    x, w = normal((m, k)), normal((k, n), k ** -0.5)
    bad += check(f"block_matmul main {m}x{k}x{n}/{t}", bm.block_matmul(x, w, t),
                 bm_ref.block_matmul(x, w, t), F32_TOL)
    # N(0,1) weights at the main shape: 2.7M outputs of sums over 4096
    # products, where the plain version's own f32 rounding comes near the
    # bar; both are also held against the float64 product
    w = normal((k, n))
    got, plain = bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t)
    exact = x.double() @ w.double()
    label = f"block_matmul {m}x{k}x{n}/{t} N(0,1) weights"
    print(f"[parity] {label}: largest |err| / bar of kernel vs plain "
          f"{ratio(got, plain, F32_TOL):.4f}, kernel vs float64 "
          f"{ratio(got, exact, F32_TOL):.4f}, plain vs float64 "
          f"{ratio(plain, exact, F32_TOL):.4f}")
    bad += check(f"{label}, kernel vs float64", got, exact, F32_TOL)
    del got, plain, exact
    m, k, n = FD_MAIN
    x, w, b = normal((m, k)), normal((k, n), k ** -0.5), normal((n,))
    bad += check(f"fused_dense main {m}x{k}x{n}", fd.fused_dense(x, w, b, "identity"),
                 fd_ref.fused_dense(x, w, b, "identity"), F32_TOL)
    del x, w, b
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for m, k, n, t in [(7, 12, 5, 2), (130, 200, 70, 3), (33, 300, 70, 3),
                           (65, 4096, 130, 4)]:
            x, w = normal((m, k), dtype=dtype), normal((k, n), dtype=dtype)
            bad += check(f"block_matmul {m}x{k}x{n}/{t} {str(dtype)[6:]}",
                         bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t), tol)
            b = normal((n,), dtype=dtype)
            bad += check(f"fused_dense {m}x{k}x{n} gelu {str(dtype)[6:]}",
                         fd.fused_dense(x, w, b, "gelu"), fd_ref.fused_dense(x, w, b, "gelu"),
                         tol)
        # a contiguous slice that starts 4 bytes past a 16-byte boundary
        base = normal((64 * 256 + 1,), dtype=dtype)
        x = base[1:].view(64, 256)
        w = normal((256, 128), dtype=dtype)
        bad += check(f"block_matmul offset 64x256x128 {str(dtype)[6:]}",
                     bm.block_matmul(x, w, 2), bm_ref.block_matmul(x, w, 2), tol)
    return bad


def time_all(tag: str) -> None:
    m, k, n, t = BM_MAIN
    x, w = normal((m, k)), normal((k, n), k ** -0.5)
    flops = 2.0 * m * n * k
    bound = max(3 * flops / TF32_PEAK, 4.0 * (m * k + k * n + m * n) / HBM) * 1e3
    tk = events_ms(lambda: bm.block_matmul(x, w, t))
    tl = events_ms(lambda: torch.matmul(x, w))
    print(f"[time] {tag} block_matmul {m}x{k}x{n}/{t}: kernel {tk:.4f} ms "
          f"({flops / tk / 1e9:.1f} TFLOP/s, {100 * bound / tk:.1f}% of the "
          f"{bound:.4f} ms 3xTF32 bound), torch.matmul {tl:.4f} ms")
    del x, w
    m, k, n = FD_MAIN
    x, w, b = normal((m, k)), normal((k, n), k ** -0.5), normal((n,))
    flops = 2.0 * m * n * k + 2.0 * m * n
    bound = max(3 * 2.0 * m * n * k / TF32_PEAK, 4.0 * (m * k + k * n + n + m * n) / HBM) * 1e3
    tk = events_ms(lambda: fd.fused_dense(x, w, b, "identity"))
    tl = events_ms(lambda: torch.addmm(b, x, w))
    print(f"[time] {tag} fused_dense {m}x{k}x{n}: kernel {tk:.4f} ms "
          f"({flops / tk / 1e9:.1f} TFLOP/s, {100 * bound / tk:.1f}% of the "
          f"{bound:.4f} ms 3xTF32 bound), torch.addmm {tl:.4f} ms")


def variants() -> int:
    src = (build.CSRC / "tc_gemm.cuh").read_text()
    out = ROOT / "build" / "variants"
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variants: {name!r} no longer matches the source")
            text = text.replace(old, new)
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "tc_gemm.cuh").write_text(text)
        for f in ("wgmma.cuh", "block_matmul.cu", "fused_dense.cu"):
            shutil.copy(build.CSRC / f, d / f)
        for lib in ("block_matmul", "fused_dense"):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"lib{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs[(name, lib)] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    for (name, lib), (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variants: {name!r} {lib} does not build:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"[variant] {name} {lib}: " + " | ".join(regs))
    real = {lib: build.entry(lib) for lib in ("block_matmul", "fused_dense")}
    bad = 0
    try:
        for rnd in range(2):
            for i, name in enumerate(VARIANTS):
                for lib in ("block_matmul", "fused_dense"):
                    fn = getattr(ctypes.CDLL(str(out / f"v{i}" / f"lib{lib}.so")), lib)
                    fn.argtypes, fn.restype = build.SIGNATURES[lib][1], ctypes.c_int
                    build._entries[lib] = fn
                if rnd == 0 and "unchecked" not in name:
                    m, k, n, t = BM_MAIN
                    x, w = normal((m, k)), normal((k, n), k ** -0.5)
                    bad += check(f"variant {name} block_matmul main",
                                 bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t),
                                 F32_TOL)
                    x, w = normal((65, 4096)), normal((4096, 130))
                    bad += check(f"variant {name} block_matmul 65x4096x130 N(0,1)",
                                 bm.block_matmul(x, w, 4), bm_ref.block_matmul(x, w, 4),
                                 F32_TOL)
                time_all(f"round {rnd} {name}:")
    finally:
        build._entries.update(real)
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--no-variants", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_bringup: CUDA is not available")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), "| torch", torch.__version__, "cuda", torch.version.cuda)
    torch.manual_seed(0)
    build.build(["block_matmul", "fused_dense"])
    for lib in ("block_matmul", "fused_dense"):
        for line in build.build_log.get(lib, "").splitlines():
            if any(s in line for s in ("registers", "spill", "Compiling entry")):
                print(f"[build] {lib}: {line.strip()}")
    bad = check_all()
    time_all("")
    if not args.no_variants:
        bad += variants()
    print(f"[bringup] {'ok' if not bad else f'{bad} checks failed'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
