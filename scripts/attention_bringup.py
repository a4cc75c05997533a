#!/usr/bin/env python3
"""Bring-up checks and times of the two attention kernels on one CUDA card.

    python3 scripts/attention_bringup.py [--no-breakdown]

1. Builds flash_attention and flash_decode from src/repro_torch/kernels/csrc
   and prints ptxas's register counts.
2. flash_attention in bf16 at the LM's prefill shape (B 4, S 2048, 32 query
   heads over 8 KV heads, D 64, causal) against its plain version (1e-2 in
   bf16, 2e-4 in f32), then its time beside SDPA's at D 64 and 128 (CUDA
   events, mean of 20 calls).
3. flash_decode against its plain version (2e-4) at the LM's decode cache
   (B 4, 4096 slots, 8 KV heads, G 4, D 64, bf16) for several filled
   lengths, and its time per call replayed from a CUDA graph over 40 layers
   (each cold in L2) beside SDPA with a one-token q.
4. Where flash_decode's time goes: variants of csrc/flash_decode.cu, built
   under build/breakdown/ with one part taken out each (the merge of the
   partials, the loads of K and V, the tensor-core sweep), timed as in 3.
   Their results are wrong by construction and are not checked.

The kernels' parity at every head dim and tile edge is
tests/test_torch_kernels_cuda.py's; the tensor-core check of their SASS is
chip_smoke.py's.
Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fdec, ref as fdec_ref  # noqa: E402

LAYERS, B, HQ, HKV, CAP, D = 40, 4, 32, 8, 4096, 64
HBM = 3.35e12  # H100 SXM data sheet, bytes/s
BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s

# parts of csrc/flash_decode.cu taken out, as (text, replacement)
NO_MERGE = ("  // the last block of this (b, h) to finish merges the n_act partials\n",
            "  if (k.n_bh > 0) return;\n")
NO_SWEEP = ("      if (ws0 + 16 * gi >= e) continue;  // the whole group is past the filled length\n",
            "      continue;\n")
NO_LOADS = ("      issue_rows<bf16, D, LD>(p, kp, vp, k_s, v_s, ws0, 16 * gi, 16, e);\n",
            "")
VARIANTS = {"kernel": [], "no merge": [NO_MERGE], "no loads": [NO_LOADS],
            "no sweep": [NO_SWEEP], "no loads, no sweep": [NO_LOADS, NO_SWEEP],
            "no loads, no sweep, no merge": [NO_LOADS, NO_SWEEP, NO_MERGE]}


def normal(shape, dtype):
    return torch.randn(shape, device="cuda").to(dtype)


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


def graph_ms(fn, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(graph.replay, reps)


def check_attention() -> int:
    bad = 0

    def one(b, hq, hkv, s, d, causal, dtype, tol):
        q = normal((b, s, hq, d), dtype).transpose(1, 2)
        k, v = (normal((b, s, hkv, d), dtype).transpose(1, 2) for _ in range(2))
        got = fa.flash_attention(q, k, v, causal)
        want = fa_ref.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                            v.transpose(1, 2), causal=causal).transpose(1, 2)
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
        print(f"[attn] {'ok' if ok else 'FAIL'} B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
              f"causal={causal} {str(dtype)[6:]} max|err|={err:.3g} (bar {tol:g})")
        return 0 if ok else 1

    bad += one(B, HQ, HKV, 2048, D, True, torch.bfloat16, 1e-2)
    bad += one(B, HQ, HKV, 2048, D, True, torch.float32, 2e-4)
    for d in (64, 128):
        q = normal((B, 2048, HQ, d), torch.bfloat16).transpose(1, 2)
        k, v = (normal((B, 2048, HKV, d), torch.bfloat16).transpose(1, 2) for _ in range(2))
        flops = 4.0 * B * HQ * d * 2048 * 2049 / 2
        tk = events_ms(lambda: fa.flash_attention(q, k, v, True))
        tl = events_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True))
        print(f"[attn time] D{d} causal bf16: kernel {tk:.4f} ms "
              f"({flops / tk / 1e9:.1f} TFLOP/s), SDPA {tl:.4f} ms, bound "
              f"{flops / BF16_PEAK * 1e3:.4f} ms")
    return bad


def decode_cache():
    ks = normal((LAYERS, B, CAP, HKV, D), torch.bfloat16)
    vs = normal((LAYERS, B, CAP, HKV, D), torch.bfloat16)
    return normal((B, HQ, D), torch.bfloat16), ks, vs


def decode_us(q, ks, vs, filled):
    n = torch.tensor(filled, dtype=torch.int32, device="cuda")
    return graph_ms(lambda: [fdec.gqa_decode_partials(q, ks[i], vs[i], n)
                             for i in range(LAYERS)]) / LAYERS * 1e3


def check_decode(q, ks, vs) -> int:
    bad = 0
    for filled in (127, 2048, 2080, 4096):
        n = torch.tensor(filled, dtype=torch.int32, device="cuda")
        got = fdec.gqa_decode_partials(q, ks[0], vs[0], n)
        want = fdec_ref.decode_partials_plain(q, ks[0], vs[0], filled, D ** -0.5)
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        ok = all(torch.allclose(x, y, rtol=2e-4, atol=2e-4) for x, y in zip(got, want))
        bad += not ok
        q1 = q.view(B, HQ, 1, D)
        tl = graph_ms(lambda: [F.scaled_dot_product_attention(
            q1, ks[i, :, :filled].transpose(1, 2), vs[i, :, :filled].transpose(1, 2),
            enable_gqa=True) for i in range(LAYERS)]) / LAYERS * 1e3
        nbytes = 2.0 * (B * HQ * D + 2 * B * filled * HKV * D) + 4.0 * (B * HQ * D + 2 * B * HQ)
        tk = decode_us(q, ks, vs, filled)
        print(f"[decode] {'ok' if ok else 'FAIL'} filled {filled}: max|err| acc/m/l "
              f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (bar 2e-4); kernel {tk:.2f} us "
              f"({nbytes / tk / 1e3:.0f} GB/s), SDPA {tl:.2f} us, bound "
              f"{nbytes / HBM * 1e6:.2f} us")
    return bad


def breakdown(q, ks, vs) -> None:
    src = (build.CSRC / "flash_decode.cu").read_text()
    out = ROOT / "build" / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"breakdown: variant {name!r} no longer matches the source")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out / f"libv{i}.so"), str(cu)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                           stderr=subprocess.STDOUT))
    for name, (_, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"breakdown: variant {name!r} does not build")
    fdec.chunk_slots(D, torch.bfloat16)  # loads the real library first
    real = build._entries["flash_decode"]
    try:
        for rnd in range(2):
            for name, (i, _) in procs.items():
                fn = ctypes.CDLL(str(out / f"libv{i}.so")).flash_decode
                fn.argtypes, fn.restype = build.SIGNATURES["flash_decode"][1], ctypes.c_int
                build._entries["flash_decode"] = fn
                times = "  ".join(f"filled {f}: {decode_us(q, ks, vs, f):.2f} us"
                                  for f in (127, 2048, 4096))
                print(f"[breakdown {rnd}] {name}: {times}")
    finally:
        build._entries["flash_decode"] = real


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--no-breakdown", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_bringup: CUDA is not available")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), "| torch", torch.__version__, "cuda", torch.version.cuda)
    torch.manual_seed(0)
    build.build(["flash_attention", "flash_decode"])
    for lib in ("flash_attention", "flash_decode"):
        for line in build.build_log.get(lib, "").splitlines():
            if "registers" in line:
                print(f"[build] {lib}: {line.strip()}")
    bad = check_attention()
    q, ks, vs = decode_cache()
    bad += check_decode(q, ks, vs)
    if not args.no_breakdown:
        breakdown(q, ks, vs)
    print(f"[bringup] {'ok' if not bad else f'{bad} checks failed'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
