#!/usr/bin/env python3
"""Bring-up checks and times of the decision_forest kernel on one CUDA card.

    python3 scripts/forest_bringup.py [--no-variants] [--baseline SOURCE.cu]

1. Builds decision_forest from src/repro_torch/kernels/csrc and prints
   ptxas's registers, spills and shared memory per kernel instance.
2. The kernel against its plain version (ref.py) at rtol = atol = 1e-4:
   the main path's shape (analytics_q1 at scale 100: 289,000 rows x 29
   features, 100 trees of depth 9), the five workload forests at 5,000
   rows, ragged n, n < 32, T not a multiple of the tree chunk, d = 4096
   (the global-read instance), ties at the thresholds, feat out of range;
   repeat calls bit-equal.
3. Times (mean of 20 replays of a CUDA graph of one call, and of 20 eager
   calls, host overhead included) at the main shape and at the
   workload forests at scale 1.0's row counts, beside the roofline bound
   (bytes at the HBM rate) and the design's shared-memory request floor
   (ops.request_floor_ms at the SM clock nvidia-smi reads as its maximum).
4. The time split, in two rounds: other tilings of the same source
   (checked: rows from global memory, BM 1024, BM 512 with two blocks an
   SM, BM 256 with one row a thread; at analytics_q1's scale-1.0 rows,
   one-warp blocks without the tree split), and variants of the source
   built under build/variants/forest/ with one part changed each (one tree
   a walk, checked; timed only, their results wrong by construction: record
   loads without bank conflicts, and the staging alone, without the walk,
   with and without its fix-up pass, row copies and later tree chunks).
   ``--baseline`` also times an earlier source of the kernel with the C
   entry of the first port (10 arguments).

Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decision_forest import ops as df, ref as df_ref  # noqa: E402

HBM = 3.35e12  # H100 SXM data sheet, bytes/s
TOL = 1e-4
MAIN = (289_000, 29, 100, 9)
# the workload forests (d, T, depth) and their rows at scale 1.0
WORKLOADS = {"analytics_q1": (2890, 29, 100, 9), "analytics_q2": (790, 96, 1, 9),
             "analytics_q3": (700, 128, 100, 9), "retail_q2": (900, 32, 160, 6),
             "simple_q2": (800, 40, 50, 6)}

# variants of csrc/decision_forest.cu, as (text, replacement); those marked
# unchecked compute something else on purpose and are only timed
NO_WALK = ("for (int l = 0; l < depth; ++l) {", "for (int l = 0; l < 0; ++l) {")
TREES_ONCE = [  # every chunk reuses the first chunk's buffer: no further copies
    ("if (stages == 2 && c + 1 < n_chunks) {", "if (stages == 2 && c + 1 < n_chunks && false) {"),
    ("(size_t)(c % stages) * buf_bytes", "(size_t)0 * buf_bytes"),
    ("for (int i = tid; i < count * n_int; i += threads)\n      rec[i].x =",
     "for (int i = tid; c == 0 && i < count * n_int; i += threads)\n      rec[i].x =")]
NO_FIXUP = ("for (int i = tid; i < count * n_int; i += threads)\n      rec[i].x =",
            "for (int i = tid; c < 0 && i < count * n_int; i += threads)\n      rec[i].x =")
NO_ROWS = ("hop::cp_async4(hop::smem_u32(s_x + (size_t)f * bm + r), xg[j] + f, ok);",
           "(void)ok;")
VARIANTS = {
    "one tree a walk": [("for (; k + (TREES - 1) * tsplit < count; k += TREES * tsplit)",
                         "for (; false; k += TREES * tsplit)")],
    # every level reads among the first 16 records: a half-warp's 8-byte
    # loads without bank conflicts, the same walk otherwise
    "records conflict-free (unchecked)": [
        ("r[t][j] = *reinterpret_cast<const int2*>(rb[t] + off[t][j]);",
         "r[t][j] = *reinterpret_cast<const int2*>(rb[t] + (off[t][j] & 127));")],
    # the staging alone, and what its parts cost
    "no walk (unchecked)": [NO_WALK],
    "no walk, no fix-up pass (unchecked)": [NO_WALK, NO_FIXUP],
    "no walk, no row copies (unchecked)": [NO_WALK, NO_ROWS],
    "no walk, trees copied once (unchecked)": [NO_WALK] + TREES_ONCE,
    "no walk, trees copied once, no row copies (unchecked)": [NO_WALK, NO_ROWS] + TREES_ONCE,
}


def inputs(n, d, t, depth, gen):
    nn = 2 ** depth - 1
    return (torch.randn((n, d), generator=gen, device="cuda"),
            torch.randint(0, d, (t, nn), generator=gen, device="cuda", dtype=torch.int32),
            torch.randn((t, nn), generator=gen, device="cuda"),
            torch.randn((t, 2 ** depth), generator=gen, device="cuda"))


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
    """Mean device time of ``fn`` replayed from a CUDA graph: at the small
    shapes a launch takes less device time than the host needs to issue it."""
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


def check(label, got, want) -> int:
    ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"[parity] {'ok' if ok else 'FAIL'} {label}: max|err|={err:.3g} "
          f"(bar rtol=atol={TOL:g})")
    return 0 if ok else 1


def check_all(gen) -> int:
    bad = 0
    cases = [("main", MAIN)] + [(k, (5000,) + v[1:]) for k, v in WORKLOADS.items()]
    cases += [("ragged n", (1001, 29, 100, 9)), ("n < 32", (7, 29, 100, 9)),
              ("T not a multiple of the chunk", (3000, 29, 23, 9)),
              ("d 4096, global rows", (500, 4096, 30, 9)), ("depth 3", (20, 8, 4, 3))]
    for label, shape in cases:
        args = inputs(*shape, gen)
        before = df.launches
        got = df.forest_predict(*args)
        tiling = df.forest_tiling(*shape, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
        bad += check(f"{label} {shape} {tiling}", got, df_ref.forest_predict(*args))
        again = df.forest_predict(*args)
        if not torch.equal(got, again) or df.launches != before + 2:
            print(f"[parity] FAIL {label}: repeat not bit-equal or launches off")
            bad += 1
    # x and thresholds on a few integers, so that many compares tie (strict
    # >), then feat out of range both ways
    x, feat, thresh, leaf = inputs(3000, 29, 40, 9, gen)
    x, thresh = x.round(), thresh.round()
    bad += check("x == thresh ties", df.forest_predict(x, feat, thresh, leaf),
                 df_ref.forest_predict(x, feat, thresh, leaf))
    feat = torch.randint(-40, 70, feat.shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    bad += check("feat out of range", df.forest_predict(x, feat, thresh, leaf),
                 df_ref.forest_predict(x, feat, thresh, leaf))
    return bad


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def max_clock_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def time_all(tag: str, gen, cases) -> None:
    """Times each (label, shape, {name: tiling}) of ``cases``."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_clock_hz()
    for label, (n, d, t, depth), tilings in cases:
        args = inputs(n, d, t, depth, gen)
        nbytes = 4.0 * (n * d + t * (2 * (2 ** depth - 1) + 2 ** depth) + n)
        bound = nbytes / HBM * 1e3
        floor = df.request_floor_ms(n, t, depth, n_sm, clock)
        for name, tiling in tilings.items():
            ms = graph_ms(lambda: df.launch(*args, tiling))
            eager = events_ms(lambda: df.launch(*args, tiling))
            print(f"[time] {tag}{name} {label} {n}x{d} T{t} D{depth} {tiling}: kernel "
                  f"{ms:.4f} ms (graph replay; eager {eager:.4f} ms); bytes bound "
                  f"{bound:.4f} ms, request floor {floor:.4f} ms ({floor / ms * 100:.1f}% "
                  f"of it)")


def workload_cases():
    """The main shape and the workload forests, each at the tiling it gets."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return [(label, shape, {"": df.forest_tiling(*shape, n_sm)})
            for label, shape in [("main", MAIN)] + list(WORKLOADS.items())]


def tiling_cases():
    """Other tilings of the same source: at the main shape, rows from global
    memory, other row tiles, two blocks an SM; at analytics_q1's scale-1.0
    rows, one-warp blocks without the tree split."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tb = df.tree_bytes(MAIN[3])

    def tiled(shape, bm, threads, rows, walk_trees, chunk=None, tsplit=1):
        room = df.SMEM_LIMIT - bm * shape[1] * 4
        chunk = chunk or room // (2 * tb)
        return df.ForestTiling(bm=bm, threads=threads, rows=rows, walk_trees=walk_trees,
                               chunk=chunk, stages=2, tsplit=tsplit, stage_x=True,
                               smem=bm * shape[1] * 4 + 2 * chunk * tb)
    base = df.forest_tiling(*MAIN, n_sm)
    small = WORKLOADS["analytics_q1"]
    return [("main", MAIN, {
        "tiling": base,
        "rows from global": dataclasses.replace(
            base, stage_x=False, smem=base.smem - base.bm * MAIN[1] * 4),
        "BM 1024": tiled(MAIN, 1024, 256, 4, 2),
        "BM 512, chunk 4: 2 blocks an SM": tiled(MAIN, 512, 256, 2, 2, 4),
        "BM 256, one row a thread": tiled(MAIN, 256, 256, 1, 4)}),
        ("analytics_q1", small, {
            "tiling": df.forest_tiling(*small, n_sm),
            "one warp a block, no tree split": tiled(small, 32, 32, 1, 4)})]


def load_variant(path: Path, signature) -> None:
    fn = getattr(ctypes.CDLL(str(path)), "forest_predict")
    fn.argtypes, fn.restype = signature, ctypes.c_int
    build._entries["forest_predict"] = fn


def variants(gen, baseline) -> int:
    src = (build.CSRC / "decision_forest.cu").read_text()
    out = ROOT / "build" / "variants" / "forest"
    sources = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variants: {name!r} no longer matches the source")
            text = text.replace(old, new)
        sources[name] = (out / f"v{i}", text)
    if baseline:
        sources["baseline"] = (out / "baseline", Path(baseline).read_text())
    procs = {}
    for name, (d, text) in sources.items():
        d.mkdir(parents=True, exist_ok=True)
        (d / "decision_forest.cu").write_text(text)
        shutil.copy(build.CSRC / "wgmma.cuh", d / "wgmma.cuh")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "decision_forest.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variants: {name!r} does not build:\n{log}")
    real = build.entry("forest_predict")
    sig = build.SIGNATURES["forest_predict"][1]
    bad = 0
    n, d, t, depth = MAIN
    try:
        for rnd in range(2):
            build._entries["forest_predict"] = real
            if rnd == 0:
                for label, shape, tilings in tiling_cases():
                    args = inputs(*shape, gen)
                    want = df_ref.forest_predict(*args)
                    for name, tiling in tilings.items():
                        bad += check(f"{name} {label} {tiling}", df.launch(*args, tiling),
                                     want)
            time_all(f"round {rnd} ", gen, tiling_cases())
            for name, (vdir, _) in sources.items():
                if name == "baseline":
                    args = inputs(n, d, t, depth, gen)
                    fn = ctypes.CDLL(str(vdir / "lib.so")).forest_predict
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    out_t = torch.empty(n, device="cuda")
                    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in (*args, out_t)]
                    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
                    ms = events_ms(lambda: fn(*ptrs, n, d, t, depth, stream))
                    if rnd == 0:
                        bad += check("baseline main", out_t, df_ref.forest_predict(*args))
                    print(f"[time] round {rnd} baseline main: kernel {ms:.4f} ms")
                    continue
                load_variant(vdir / "lib.so", sig)
                if rnd == 0 and "unchecked" not in name:
                    args = inputs(n, d, t, depth, gen)
                    bad += check(f"variant {name} main", df.forest_predict(*args),
                                 df_ref.forest_predict(*args))
                time_all(f"round {rnd} {name} ", gen, workload_cases()[:1])
    finally:
        build._entries["forest_predict"] = real
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--no-variants", action="store_true")
    parser.add_argument("--baseline", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("forest_bringup: CUDA is not available")
        return 1
    print(smi("name,power.limit"), "| clocks.max.sm", smi("clocks.max.sm"),
          "| torch", torch.__version__, "cuda", torch.version.cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)
    build.build(["decision_forest"])
    for line in build.build_log.get("decision_forest", "").splitlines():
        if any(s in line for s in ("registers", "spill", "Compiling entry")):
            print(f"[build] {line.strip()}")
    bad = check_all(gen)
    time_all("", gen, workload_cases())
    if not args.no_variants:
        bad += variants(gen, args.baseline)
    print(f"[bringup] {'ok' if not bad else f'{bad} checks failed'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
