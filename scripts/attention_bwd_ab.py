#!/usr/bin/env python3
"""flash_attention's backward: other sources of csrc/flash_attention_bwd.cu
against this checkout's, on one CUDA card.

    python3 scripts/attention_bwd_ab.py OTHER.cu [OTHER.cu ...]

1. Builds each OTHER.cu and this checkout's source side by side under
   build/variants/ (the repo's nvcc flags, plus ``-Xcompiler
   -fno-gnu-unique``: the libraries share kernel names, and a ``static``
   inside a template is otherwise one symbol process-wide, so a second
   library would launch without its shared-memory attribute), and prints
   ptxas's registers and spills for each (``chip_smoke.bwd_ptxas``).
2. Holds each build to the plain backward in bf16 (3e-2) at every head-dim
   kind (64, 128, 192/128, 160, 64/32, 16) and S, Skv off the tiles, then
   at ``chip_smoke.BWD_MAIN_SHAPES`` with two calls bit-equal.
3. Times the builds that passed at ``chip_smoke.BWD_TIME_SHAPES`` in turns
   (each build once, then in reverse order; CUDA events, mean of 20
   calls), beside SDPA's backward before and after, and prints the
   profiler's split of one call by kernel (Dr, dK/dV, dQ).

The name of a build is its file's stem; this checkout's is "current".
Exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

CHECK_PAIRS = [(64, 64), (128, 128), (192, 128), (160, 160), (64, 32), (16, 16)]
CHECK_SHAPES = [(1, 8, 1, 257, 129), (1, 4, 2, 192, 257), (2, 4, 2, 37, 37)]  # B Hq Hkv S Skv


def build_all(sources: dict) -> dict:
    """name -> the flash_attention_bwd entry of that source's build."""
    from repro_torch.kernels import build
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src in sources.items():
        lib = out / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-I",
               str(build.CSRC), "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    build.build(["flash_attention"])  # the forward, for o and lse
    entries = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[ab] {name} does not build:\n{log[-4000:]}")
            continue
        print(f"[ab] {name}:")
        try:
            C.bwd_ptxas(log)
        except AssertionError as e:
            print(f"[ab] {name}: {e}")
        f = ctypes.CDLL(str(lib)).flash_attention_bwd
        f.argtypes = build.SIGNATURES["flash_attention_bwd"][1]
        f.restype = ctypes.c_int
        entries[name] = f
    return entries


def main() -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    sources = {Path(a).stem: Path(a) for a in sys.argv[1:]}
    sources["current"] = build.CSRC / "flash_attention_bwd.cu"
    C.phase_device()
    t0 = time.perf_counter()
    entries = build_all(sources)
    print(f"[ab] built in {time.perf_counter() - t0:.1f} s", flush=True)

    def use(name):
        build._entries["flash_attention_bwd"] = entries[name]

    gen = torch.Generator(device="cuda").manual_seed(8)
    bad = set()
    for name in entries:
        use(name)
        for d, dv in CHECK_PAIRS:
            for b, hq, hkv, s, skv in CHECK_SHAPES:
                for causal in (True, False):
                    try:
                        C.bwd_vs_plain(C._bwd_inputs(gen, b, hq, hkv, s, skv, d, dv,
                                                     torch.bfloat16), causal, C.BF16_TOL, name)
                    except Exception as e:  # noqa: BLE001 - report every failing case
                        bad.add(name)
                        print(f"[ab] {name} fails {(b, hq, hkv, s, skv, d, dv, causal)}: "
                              f"{str(e)[:200]}")
        for label, (b, hq, hkv, s, skv, d, dv, causal) in C.BWD_MAIN_SHAPES.items():
            q, k, v, do = C._bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, torch.bfloat16)
            try:
                err, ratio = C.bwd_vs_plain((q, k, v, do), causal, C.BF16_TOL, f"{name} {label}")
                o, lse, _ = C._plain_bwd(q, k, v, do, causal)
                first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
                second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
                equal = all(torch.equal(x, y) for x, y in zip(first, second))
                print(f"[ab] {name} {label}: max|err| {err:.3g} (largest |err| / bar "
                      f"{ratio:.3f}), two calls bit-equal {equal}")
                if not equal:
                    bad.add(name)
            except Exception as e:  # noqa: BLE001
                bad.add(name)
                print(f"[ab] {name} fails {label}: {str(e)[:200]}")
            del q, k, v, do
            C._free()
    good = [n for n in entries if n not in bad]
    print(f"[ab] parity: failing {sorted(bad)}", flush=True)

    for label, (b, hq, hkv, s, skv, d, dv, causal) in C.BWD_TIME_SHAPES.items():
        q, k, v, do = C._bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, torch.bfloat16)
        o, lse = fa._forward(q, k, v, causal, with_lse=True)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa = C._sdpa_bwd(leaves, do, causal)
        kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        times = {n: [] for n in good}
        sdpa_ms = [C.cuda_ms(sdpa)]
        for n in good + good[::-1]:
            use(n)
            times[n].append(C.cuda_ms(kernel, reps=20))
        sdpa_ms.append(C.cuda_ms(sdpa))
        flops = fa.bwd_flops(b, hq, s, skv, d, dv, causal)
        parts = []
        for n in good:
            use(n)
            split = C.device_ms_by_kernel(kernel)
            by_part = " ".join(f"{p} {sum(ms for k_, ms in split.items() if pat in k_):.4f}"
                               for p, pat in C.BWD_PARTS.items())
            parts.append(f"{n} {times[n][0]:.4f}/{times[n][1]:.4f} ms "
                         f"({flops / min(times[n]) / 1e9:.0f} TFLOP/s; {by_part})")
        print(f"[ab] {label}: SDPA {sdpa_ms[0]:.4f}/{sdpa_ms[1]:.4f} ms; " + "; ".join(parts),
              flush=True)
        del q, k, v, do, o, lse, leaves, sdpa
        C._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
