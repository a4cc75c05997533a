#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN.
2. build: compiles the three CUDA kernels from src/repro_torch/kernels/csrc.
3. kernel parity: each kernel's wrapper against its plain PyTorch version on
   the card, at the JAX package's kernel-test shapes and at the main path's
   shapes (bars: 1e-4 in float32, 3e-2 in bfloat16).
4. main path: all 12 workloads at scale 1.0. ``execute`` on the card
   (backend ``torch``) against ``execute_reference`` on the CPU, then the
   kernel path (``core.rules.kernel_plan``: R3-1/R3-2, R4-2, R4-1-fuse, R4-2)
   against the torch result, at rtol=atol=5e-4 with int columns and row sets
   exact. Launch counts are zeroed just before and read just after.
5. full size: analytics_q1 at scale 100 (289,000 rows x 29 features, a
   100-tree depth-9 forest) and rec_q3 at scale 20 (1,320 movies, 4096-d
   tags, a 1.74M-row cross join), through the kernel path and the torch path,
   median of 5 timed runs each and one profiled run each (device busy
   share, top kernels); then each kernel's time at its main-path shape
   beside its plain version, one library call, and its bound.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.testing import assert_canonical_close  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 3e-2
FULL_SIZE = (("analytics_q1", 100.0), ("rec_q3", 20.0))
TIMED_RUNS = 5

# Data sheet peaks per H100 form factor: (non-tensor f32 FLOP/s, HBM B/s)
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}

KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                     "src/repro/kernels/block_matmul/kernel.py:42"),
    "decision_forest": ("src/repro_torch/kernels/csrc/decision_forest.cu",
                        "src/repro/kernels/decision_forest/kernel.py:67"),
    "fused_dense": ("src/repro_torch/kernels/csrc/fused_dense.cu",
                    "src/repro/kernels/fused_dense/kernel.py:61"),
}


def _kernel_modules():
    from repro_torch.kernels.block_matmul import ops as bm
    from repro_torch.kernels.decision_forest import ops as df
    from repro_torch.kernels.fused_dense import ops as fd
    return {"block_matmul": bm, "decision_forest": df, "fused_dense": fd}


def reset_launches() -> None:
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def assert_finite(d: dict, label: str) -> None:
    for k, v in d.items():
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"{label}:{k} has non-finite values")


def kernel_vs_plain(got: torch.Tensor, want: torch.Tensor, tol: float,
                    label: str) -> float:
    """|got - want| <= tol + tol * |want| everywhere; returns max |err|."""
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{label}: {m}")
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_run_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` single calls after one warm-up, CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_breakdown(label: str, fn, top: int = 4) -> None:
    """One traced call of ``fn``: wall time, device busy time (the sum of
    the device kernels' times; the host ops that launch them are not
    counted again) and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    tops = "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in rows[:top])
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (traced), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.0f}%), "
          f"{sum(r[2] for r in rows)} kernels; top: {tops}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"kind={name} count={torch.cuda.device_count()}")
    return name


def phase_build() -> None:
    from repro_torch.kernels import build
    secs = build.build()
    print(f"[build] {len(build.LIBRARIES)} libraries in {secs:.1f} s")
    for lib, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")


def _normal(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _forest_inputs(gen, n, d, t, depth):
    nn = 2 ** depth - 1
    return (_normal(gen, (n, d)),
            torch.randint(0, d, (t, nn), generator=gen, device="cuda",
                          dtype=torch.int32),
            _normal(gen, (t, nn)), _normal(gen, (t, 2 ** depth)))


def main_path_shapes() -> dict:
    """The largest shape each kernel gets on the full-size runs."""
    n_movies = max(24, int(66 * 20.0))  # movielens.build at rec_q3's scale 20
    return {
        # rec_q3 at scale 20: the autoencoder's 4096 x 2048 weight, n_tiles 16
        "block_matmul": (n_movies, 4096, 2048, 16),
        # rec_q3 at scale 20: cos_sim's towers over the 1320^2-row cross join
        "fused_dense": (n_movies * n_movies, 256, 256, "identity"),
        # analytics_q1 at scale 100: 289,000 rows x 29, 100 trees of depth 9
        "decision_forest": (max(256, int(2890 * 100.0)), 29, 100, 9),
    }


def phase_parity(shapes: dict) -> dict:
    """Kernel against plain version; returns max |err| at main-path shapes."""
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for m, k, n, t in [(10, 16, 40, 4), (130, 300, 520, 8), (64, 512, 1024, 16)]:
        x, w = _normal(gen, (m, k)), _normal(gen, (k, n))
        kernel_vs_plain(bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t),
                        F32_TOL, f"block_matmul {m}x{k}x{n}/{t}")
    xb, wb = _normal(gen, (64, 96), dtype=torch.bfloat16), _normal(gen, (96, 32), dtype=torch.bfloat16)
    kernel_vs_plain(bm.block_matmul(xb, wb, 2), bm_ref.block_matmul(xb, wb, 2),
                    BF16_TOL, "block_matmul bf16")
    m, k, n, t = shapes["block_matmul"]
    x, w = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5)
    errs["block_matmul"] = kernel_vs_plain(
        bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t), F32_TOL,
        f"block_matmul main path {m}x{k}x{n}/{t}")
    print(f"[parity] block_matmul ok: 4 test shapes + bf16; main path "
          f"{m}x{k}x{n} n_tiles={t} max|err|={errs['block_matmul']:.3g}")

    for m, k, n in [(7, 12, 5), (130, 200, 70), (256, 512, 128), (1, 128, 128)]:
        for act in fd_ref.ACTS:
            x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n)), _normal(gen, (n,))
            kernel_vs_plain(fd.fused_dense(x, w, b, act), fd_ref.fused_dense(x, w, b, act),
                            F32_TOL, f"fused_dense {m}x{k}x{n} {act}")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        x, w, b = (_normal(gen, s, dtype=dtype) for s in ((64, 96), (96, 32), (32,)))
        kernel_vs_plain(fd.fused_dense(x, w, b, "relu"), fd_ref.fused_dense(x, w, b, "relu"),
                        tol, f"fused_dense {dtype}")
    try:
        fd.fused_dense(x, w, b, "softmax")
        raise AssertionError("fused_dense accepted softmax")
    except ValueError:
        pass
    m, k, n, act = shapes["fused_dense"]
    x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5), _normal(gen, (n,))
    errs["fused_dense"] = kernel_vs_plain(
        fd.fused_dense(x, w, b, act), fd_ref.fused_dense(x, w, b, act), F32_TOL,
        f"fused_dense main path {m}x{k}x{n}")
    del x, w, b
    print(f"[parity] fused_dense ok: 4 test shapes x {len(fd_ref.ACTS)} activations, "
          f"f32 + bf16, softmax refused; main path {m}x{k}x{n} {act} "
          f"max|err|={errs['fused_dense']:.3g}")

    for n, d, t, depth in [(20, 8, 4, 3), (150, 16, 10, 5), (64, 29, 25, 6)]:
        args = _forest_inputs(gen, n, d, t, depth)
        kernel_vs_plain(df.forest_predict(*args), df_ref.forest_predict(*args),
                        F32_TOL, f"forest {n}x{d} T={t} D={depth}")
    args = _forest_inputs(gen, *shapes["decision_forest"])
    errs["decision_forest"] = kernel_vs_plain(
        df.forest_predict(*args), df_ref.forest_predict(*args), F32_TOL,
        "forest main path")
    print(f"[parity] decision_forest ok: 3 test shapes; main path "
          f"{shapes['decision_forest']} max|err|={errs['decision_forest']:.3g}")
    return errs


def phase_main_path() -> dict:
    from repro_torch.core.executor import execute, execute_reference
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS
    plans = {}
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        plans[name] = (w, kernel_plan(w.plan, w.catalog))
    reset_launches()
    for name, (w, kplan) in plans.items():
        t0 = time.perf_counter()
        ref = execute_reference(w.plan, w.catalog, device="cpu").canonical()
        out = execute(w.plan, w.catalog, backend="torch", device="cuda").canonical()
        assert_canonical_close(ref, out, f"{name}/torch")
        kout = execute(kplan, w.catalog, device="cuda").canonical()
        assert_canonical_close(out, kout, f"{name}/kernel")
        rows = len(next(iter(out.values())))
        print(f"[main] {name} ok: {rows} rows, torch == reference, "
              f"kernel == torch ({time.perf_counter() - t0:.1f} s)")
    launches = read_launches()
    print("[main] kernels " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return launches


def phase_full_size() -> dict:
    from repro_torch.core.executor import execute
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS
    per_run = {}
    for name, scale in FULL_SIZE:
        w = ALL_WORKLOADS[name](scale=scale, device="cuda")
        kplan = kernel_plan(w.plan, w.catalog)
        out = execute(w.plan, w.catalog, backend="torch", device="cuda").canonical()
        reset_launches()
        kout = execute(kplan, w.catalog, device="cuda").canonical()
        per_run[name] = read_launches()
        assert_finite(out, name)
        assert_canonical_close(out, kout, f"{name}@{scale}/kernel")
        rows = len(next(iter(out.values())))
        torch_ms = median_run_ms(
            lambda: execute(w.plan, w.catalog, backend="torch", device="cuda"))
        kernel_ms = median_run_ms(lambda: execute(kplan, w.catalog, device="cuda"))
        print(f"[full] {name} scale={scale}: {rows} rows, kernel == torch; "
              f"median of {TIMED_RUNS}: kernel path {kernel_ms:.3f} ms, "
              f"torch path {torch_ms:.3f} ms; launches per run "
              + json.dumps(per_run[name]))
        profile_breakdown(f"{name} kernel path",
                          lambda: execute(kplan, w.catalog, device="cuda"))
        profile_breakdown(f"{name} torch path",
                          lambda: execute(w.plan, w.catalog, backend="torch",
                                          device="cuda"))
        del w, kplan
        torch.cuda.empty_cache()
    return per_run


def phase_kernel_times(shapes: dict, launches: dict, errs: dict,
                       card: str) -> list:
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    form, (flops_peak, bytes_peak) = card_peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    def record(name, kernel, plain, library, flops, nbytes, shape):
        t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
        row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "launches": launches[name],
               "max_abs_err": errs[name], "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(plain), "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": cuda_ms(library) if library else None}
        lib_ms = f"{row['library_ms']:.4f} ms" if library else "none"
        print(f"[time] {name} {shape}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib_ms}, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({form} peaks: {flops_peak / 1e12:g} TFLOP/s f32, "
              f"{bytes_peak / 1e12:g} TB/s)")
        rows.append(row)

    m, k, n, t = shapes["block_matmul"]
    x, w = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5)
    record("block_matmul", lambda: bm.block_matmul(x, w, t),
           lambda: bm_ref.block_matmul(x, w, t), lambda: torch.matmul(x, w),
           2.0 * m * n * k, 4.0 * (m * k + k * n + m * n), (m, k, n, t))
    del x, w
    m, k, n, act = shapes["fused_dense"]
    x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5), _normal(gen, (n,))
    # library yardstick: one addmm, i.e. bias + product without the activation
    record("fused_dense", lambda: fd.fused_dense(x, w, b, act),
           lambda: fd_ref.fused_dense(x, w, b, act), lambda: torch.addmm(b, x, w),
           2.0 * m * n * k + 2.0 * m * n, 4.0 * (m * k + k * n + n + m * n),
           (m, k, n, act))
    del x, w, b
    torch.cuda.empty_cache()
    n, d, t, depth = shapes["decision_forest"]
    args = _forest_inputs(gen, n, d, t, depth)
    nn = 2 ** depth - 1
    record("decision_forest", lambda: df.forest_predict(*args),
           lambda: df_ref.forest_predict(*args), None,
           float(n) * t * (depth + 1),
           4.0 * (n * d + t * (2 * nn + 2 ** depth) + n), (n, d, t, depth))
    return rows


def main() -> int:
    card = phase_device()
    phase_build()
    shapes = main_path_shapes()
    errs = phase_parity(shapes)
    launches = phase_main_path()
    phase_full_size()
    rows = phase_kernel_times(shapes, launches, errs, card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
