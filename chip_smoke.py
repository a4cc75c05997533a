#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN.
2. build: compiles the five CUDA kernels from src/repro_torch/kernels/csrc,
   one nvcc per source, all started together; prints ptxas's registers,
   shared memory and spills per decision_forest instance (and fails on a
   spill); checks in their SASS (cuobjdump) that every instance of the two
   GEMMs (block_matmul and fused_dense: f32 and bf16, 16-byte and element
   copies) and the bf16 attention instances run on tensor cores.
3. kernel parity: each kernel's wrapper against its plain PyTorch version on
   the card, at the JAX package's kernel-test shapes and, for the attention
   kernels, at the LM path's shapes (bars: 1e-4 in float32, 2e-4 for
   attention in float32, 3e-2 in bfloat16, 1e-2 for flash_attention's main
   shape in bfloat16, which also runs in float32 at 2e-4); the GEMMs also
   at rows and pointers that are not 16-byte aligned and at K = 4096 with
   N(0,1) weights; flash_attention's tensor-core instance also at head dims
   128 and 160 with a ragged S, and flash_decode called three times and
   replayed three times from a CUDA graph, all equal; decision_forest also
   at n not a multiple of its row tile, n < 32, T not a multiple of its tree
   chunk, d = 4096 (rows from global memory), the five workload forests,
   ties at the thresholds and feat out of range. The engine kernels'
   main-path shapes come in phase 5a.
4. main path: all 12 workloads at scale 1.0. ``execute`` on the card
   (backend ``torch``) against ``execute_reference`` on the CPU, then the
   kernel path (``core.rules.kernel_plan``: R3-1/R3-2, R4-2, R4-1-fuse, R4-2)
   against the torch result, at rtol=atol=5e-4 with int columns and row sets
   exact. Launch counts are zeroed just before and read just after.
   ``execute`` lowers by cost, under the profile of the card.
4a. [lower]: ``cost.DeviceProfile.detect("cuda")`` must be the H100 prior on
   an H100; the host time of one eager torch operator and of one relational
   operator (the cost model's ``op_overhead_s``); costed lowering of the 12
   workloads at scale 1.0 under the profile, as built and with R3-1/R3-2
   applied and their realizations left to lowering: tree-order and chosen
   cost, candidates scored, decision signature, sites that chose the kernel.
4b. [plan]: the 12 workloads at scale 1.0 through ``unoptimized``,
   ``heuristic``, ``greedy`` and ``vanilla_mcts`` (40 iterations, seed 0)
   with ``planner.analytic_cost_fn`` under the profile and the workload's
   memory budget; each chosen plan executed on the card against the CPU
   reference at the bar, with each kernel it names launched. Launch counts
   are read around each search and each execution; ``[main] optimizer
   kernels`` sums the executions' and prints the searches' beside them
   (the compact rule counts a filter's rows by running it).
5. full size: analytics_q1 at scale 100 (289,000 rows x 29 features, a
   100-tree depth-9 forest) and rec_q3 at scale 20 (1,320 movies, 4096-d
   tags, a 1.74M-row cross join), through the kernel path, the torch path
   and the plan ``vanilla_mcts`` chooses, median of 5 timed runs each and
   one profiled run each (device busy share, top kernels); the host time of
   the costed lowering each ``execute`` makes (median of 5). Each engine
   kernel's wrapper records the largest operand shape it gets in these
   runs: the main path's shapes of phases 5a and 7.
5a. the engine kernels' parity at those shapes: max |err| and the largest
   |err| over the bar, two repeat calls bit-equal.
5b. the learned embeddings (``core.{embedding,optimizer}``), at the paper's
   widths (Query2Vec 393-d, D_MODEL 384):
   - [embed]: an untrained embedder (seed 0) on the card and its weights
     on the CPU embed the 12 workloads (scale 1.0) and the 20 templates
     (scale 0.5): equal at rtol=atol=1e-4, unit norm, no NaN, predicted
     latencies equal; cache hits and misses; one embed miss timed through
     the captured forward (one CUDA graph replay) and eagerly, beside
     ``featurize_plan`` alone and the forward's device time either way;
   - [train]: benchmarks/optimizers.py's ``_train_embedder`` on the card,
     two-model (seed 0) and one-model (seed 1): Model2Vec on the graphs of
     ``sample_model(0..39)`` (120 steps, batch 8, lr 1e-4), Query2Vec on 60
     in-distribution template queries at scale 0.5 (120 steps, batch 8),
     the latency head on their analytic costs under the H100 prior (240
     steps, batch 12): first and last loss, ms per step, median q-error,
     log-correlation. Every loss finite; the two-model correlation > 0.5;
   - [reuse]: Table IV's fleet (40 ID + 20 OOD template queries at scale
     0.5, 20 iterations) through ``ReusableMCTS`` on each trained embedder
     and through VanillaMCTS: optimizer seconds, estimated execution,
     collision rate per split, node store; every chosen plan executed on
     the card against the reference interpreter on the CPU.
5c. [cache]: the two full-size workloads through the compiled-plan cache
   (``PlanCache.get_or_compile``, and ``compile_plan`` over the global
   cache), kernel and torch plans: the build's lowering, warm-up and capture
   seconds and the graph's pool; 5 calls on fresh instances, each equal to
   ``execute`` on the same instance at the bar, with one capture and one
   lowering; the median call (CUDA events around the input copy, the replay
   and the output clone) beside ``execute``'s. ``[main] cache kernels``
   counts the executables' launches: at warm-up and capture, never at
   replay.
5d. [serving]: the JAX package's serving traffic (benchmarks/serving_bench.py)
   on the kernel plans: B sequential dispatches against one B-wide vmapped
   dispatch of simple_q2 and simple_q3 at scale 0.08 for B in 1-16; the
   42-request 4:2:1 mix over simple_q1-3 through ``QueryServer`` against a
   batch-1 server; 4 analytics_q1@100 instances in one micro-batch (one
   forest launch over all their rows). Every batched result against its
   sequential one at 2e-5; ops that took vmap's per-example fallback are
   printed, and an engine kernel among them fails the run.
5e. [feedback]: ``calibrate_profile`` on the mix's signatures beside the
   H100 prior, and the signatures whose decisions ``apply_calibration``
   changes. Printed, not installed.
6. LM path, granite-3-2b at full width and depth (40 layers, d 2048, 32
   query heads over 8 KV heads, random weights from a seed):
   a. float32: prefill(prompt[:, :-1]) and one decode step reproduce
      forward(prompt)'s last logits within 1e-2 (tests/test_archs.py's
      bar), B 4 x S 2048;
   b. the same float32 weights cut to 2 layers, on the card (the kernels)
      and on the CPU (the plain versions), over one 64-token prompt: hidden
      states within 1e-4;
   c. Appendix K's query (examples/serve_llm_udf.py) through ``execute``
      with ``llm_summarize`` calling the float32 model: the unoptimized
      plan's scores against the factorized evaluation at the .canonical()
      bar; then the plan ``optimize_vanilla_mcts`` chooses (40 iterations,
      seed 0, the H100 prior), whose results must equal the unoptimized
      plan's at 5e-4 with fewer LLM rows summarized;
   d. bfloat16: the LM main path, prefill B 4 x 2048 tokens (max_len 4096)
      and 32 greedy decode steps, with launch counts zeroed just before and
      read just after (40 flash_attention launches per prefill, 40
      flash_decode per step); then the prefill time (median of 5 after one
      warm-up, CUDA events), peak memory, one profiled prefill (top 8
      kernels) and eager decode step;
   e. [decode-graph]: from the same prefilled cache, 32 greedy steps eagerly
      (``make_decode_step``) and through ``Server``'s captured step (one
      CUDA-graph replay a step): tokens equal, logits within 3e-2; each
      path's ms per step and tokens/s (medians of 5 runs of 32 steps after
      a warm-up, CUDA events), the capture's seconds and pool, one
      profiled replay (device-busy share);
   f. ``Server``: 8 requests, prompts of 4-11 tokens, max_new 16, batch 4,
      max_len 256 (launch/serve.py main's settings), through the captured
      step and through the same server stepping eagerly: the same tokens,
      both rates.
7. each kernel's time at its main-path shape beside its plain version, one
   library call, and its bound; its achieved TFLOP/s or GB/s and its share
   of the bound. The f32 GEMMs' bound is the least time for f32-accurate work
   on the tensor cores, 3 x 2MNK at the TF32 rate (their three-way split),
   with the CUDA-core f32 bound printed beside it. decision_forest's bound
   is bytes; beside it the line prints its design's floor, the
   shared-memory requests of its walk at one wavefront per SM per clock.
8. the other GQA families of the LM path, each freed before the next loads:
   a. [parity]: flash_attention (bf16, bar 1e-2) at qwen2-vl's prefill
      shape (Hq 64 / Hkv 8, D 128), granite-moe's (16 / 8), seamless's
      self-attention (16 / 16, causal and not) and cross-attention (Skv
      2048 and 1000, non-causal); flash_decode (partials at 2e-4) at G 8 /
      D 128, G 2 and G 1 (self and cross); each kernel's time beside SDPA's;
   b. [lm-moe] granite-moe-1b-a400m at full width and depth (24 layers, 32
      experts top-8): in f32, prefill(prompt[:, :-1]) + 1 decode step ==
      forward's last logits (1e-2) and 2 layers card vs CPU (1e-4), at B 2 x
      64 (dropless); in bf16 the share of routed assignments prefill drops
      at B 4 x 2048, then the family's main path;
   c. [lm-mrope] qwen2-vl-72b at full width, 16 of 80 layers: 2 f32 layers
      card vs CPU with seeded M-RoPE ids; the main path with seeded ids;
   d. [lm-encdec] seamless-m4t-medium at full width and depth (12 + 12
      layers), the encoder over B 4 x 2048 seeded frames: 2+2 f32 layers
      card vs CPU; the main path; the server over an empty encoder memory
      (finite logits).
   A family's main path: bf16 prefill of B 4 x 2048 tokens (max_len 4096)
   and step e, launch counts zeroed just before and read just after (the
   eager steps' and the capture's launches), then the prefill's time and
   the peak memory.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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

F32_TOL, BF16_TOL, ATTN_TOL = 1e-4, 3e-2, 2e-4
# flash_attention's main shape in bf16: its outputs average ~i/e keys, so a
# typical |o| is ~0.05 and 3e-2 would hide a systematic error; one bf16 ulp
# of an output near 1 is 3.9e-3
ATTN_BF16_TOL = 1e-2
CONSISTENCY_TOL = 1e-2  # tests/test_archs.py: decode against forward
CARD_CPU_TOL = 1e-4  # two f32 layers, card against CPU (phase 6b)
FULL_SIZE = (("analytics_q1", 100.0), ("rec_q3", 20.0))
TIMED_RUNS = 5
LM_ARCH = "granite-3-2b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = 4, 2048, 4096, 32

# Data sheet peaks per H100 form factor: (non-tensor f32 FLOP/s, HBM B/s,
# dense bf16 tensor-core FLOP/s, dense TF32 tensor-core FLOP/s)
PEAKS = {"PCIe": (51e12, 2.0e12, 756e12, 378e12),
         "NVL": (60e12, 3.9e12, 835e12, 417.5e12),
         "SXM": (67e12, 3.35e12, 989e12, 494.7e12)}

KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                     "src/repro/kernels/block_matmul/kernel.py:42"),
    "decision_forest": ("src/repro_torch/kernels/csrc/decision_forest.cu",
                        "src/repro/kernels/decision_forest/kernel.py:67"),
    "fused_dense": ("src/repro_torch/kernels/csrc/fused_dense.cu",
                    "src/repro/kernels/fused_dense/kernel.py:61"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:71"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:70"),
}
ENGINE_KERNELS = ("block_matmul", "decision_forest", "fused_dense")  # phase 4
LM_KERNELS = ("flash_attention", "flash_decode")  # phase 6d


def _kernel_modules():
    from repro_torch.kernels.block_matmul import ops as bm
    from repro_torch.kernels.decision_forest import ops as df
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fdec
    from repro_torch.kernels.fused_dense import ops as fd
    return {"block_matmul": bm, "decision_forest": df, "fused_dense": fd,
            "flash_attention": fa, "flash_decode": fdec}


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


def graph_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph. For work whose
    kernels are shorter than the host's launch overhead, events around
    eager calls time the host; a graph replay leaves only the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps=reps)


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


def median_host_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` single calls after one warm-up, host clock, for
    work that runs on the host only."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_breakdown(label: str, fn, top: int = 4, also: tuple = ()) -> None:
    """One traced call of ``fn``: wall time, device busy time (the sum of
    the device kernels' times; the host ops that launch them are not
    counted again), the kernels that take the most of it, and those outside
    the top whose names contain a string of ``also``."""
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
    shown = rows[:top] + [r for r in rows[top:] if any(a in r[0] for a in also)]
    tops = "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in shown)
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (traced), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.0f}%), "
          f"{sum(r[2] for r in rows)} kernels; top: {tops}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _n_sm() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    print(_smi("name,power.limit"))
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
        if lib == "decision_forest":
            forest_ptxas(log)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")
    phase_sass(build)


def forest_ptxas(log: str) -> None:
    """ptxas's registers, shared memory and spills for each decision_forest
    instance (ROWS rows x TREES trees a thread, rows staged or read from
    global memory); fails on a spill."""
    import re
    name, spills = None, {}
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*forest_kernelILi(\d)ELi(\d)ELb([01])E", line)
        if entry:
            rows, trees, staged = entry.groups()
            name = (f"forest_kernel<{rows} rows, {trees} trees, "
                    f"{'rows staged' if staged == '1' else 'rows from global'}>")
        elif name and "spill" in line:
            props = line.split(":")[-1].strip()
            spills[name] = [int(v) for v in re.findall(r"(\d+) bytes spill", props)]
        elif name and "registers" in line:
            static = re.search(r"(\d+) bytes smem", line)
            print(f"[build] decision_forest {name}: {line.split(':')[-1].strip()}; "
                  f"{spills.get(name)} bytes spill stores / loads; shared memory "
                  f"{static.group(1) if static else 0} bytes static, the rest dynamic "
                  f"from ops.forest_tiling")
            name = None
    if len(spills) != 10 or any(sum(v) for v in spills.values()):
        raise AssertionError(f"decision_forest: want 10 instances, none spilling: {spills}")


# kernel instances that must run on tensor cores: (library, what an instance
# is named by, mangled-name pattern, instances, the instruction their SASS
# must hold)
TENSOR_CORE_KERNELS = (
    ("block_matmul", "f32 copies", r"gemm_tf32x3ILb([01])E", 2, "HGMMA"),
    ("block_matmul", "bf16 copies", r"gemm_bf16ILb([01])E", 2, "HMMA"),
    ("fused_dense", "f32 copies", r"gemm_tf32x3ILb([01])E", 2, "HGMMA"),
    ("fused_dense", "bf16 copies", r"gemm_bf16ILb([01])E", 2, "HMMA"),
    ("flash_attention", "bf16 head dim", r"flash_fwd_bf16ILi(\d+)E", 5, "HGMMA"),
    ("flash_decode", "bf16 head dim", r"decode_tcILi(\d+)E", 5, "HMMA"))
_READABLE = {"1": "16-byte", "0": "element"}


def phase_sass(build) -> None:
    """Tensor-core instructions in the SASS (cuobjdump of the built
    libraries): HGMMA (wgmma) in every f32 instance of the two GEMMs and
    every bf16 flash_attention instance, HMMA (mma.sync) in every bf16
    instance of the GEMMs and of flash_decode's sweep."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dumps = {}
    for lib, named_by, pattern, instances, want in TENSOR_CORE_KERNELS:
        if lib not in dumps:
            dumps[lib] = subprocess.run([tool, "--dump-sass", str(build._lib_path(lib))],
                                        capture_output=True, text=True, check=True,
                                        timeout=120).stdout
        counts, name = {}, None
        for line in dumps[lib].splitlines():
            if "Function :" in line:
                found = re.search(pattern, line)
                name = ("/".join(_READABLE.get(g, g) for g in found.groups())
                        if found else None)
                if name:
                    counts[name] = 0
            elif name and want in line:
                counts[name] += 1
        print(f"[sass] {lib}: {want} per instance by {named_by} " + json.dumps(counts))
        if len(counts) != instances or min(counts.values()) == 0:
            raise AssertionError(f"{lib}: want {instances} instances, each with "
                                 f"{want}: {counts}")


def _normal(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _forest_inputs(gen, n, d, t, depth):
    nn = 2 ** depth - 1
    return (_normal(gen, (n, d)),
            torch.randint(0, d, (t, nn), generator=gen, device="cuda",
                          dtype=torch.int32),
            _normal(gen, (t, nn)), _normal(gen, (t, 2 ** depth)))


def _engine_wrappers() -> dict:
    """kernel -> (wrapper's module, its name, the shape of one call's
    operands: (m, k, n, n_tiles), (m, k, n, act) or (n, d, T, depth))."""
    from repro_torch.kernels.block_matmul import ops as bm
    from repro_torch.kernels.decision_forest import ops as df
    from repro_torch.kernels.fused_dense import ops as fd
    return {
        "block_matmul": (bm, "block_matmul", lambda x, w, n_tiles=8: (
            x.shape[0], x.shape[1], w.shape[1], n_tiles)),
        "fused_dense": (fd, "fused_dense", lambda x, w, b, act="identity": (
            x.shape[0], x.shape[1], w.shape[1], act)),
        "decision_forest": (df, "forest_predict", lambda x, feat, thresh, leaf: (
            x.shape[0], x.shape[1], feat.shape[0], leaf.shape[1].bit_length() - 1)),
    }


def _work(shape: tuple) -> int:
    return int(np.prod([v for v in shape if isinstance(v, int)]))


@contextlib.contextmanager
def recording_shapes(seen: dict):
    """Inside it, each engine kernel's wrapper keeps in ``seen[kernel]`` the
    largest operand shape (by the product of its sizes) of its calls on
    the card. The plans look the wrappers up at each call, so they go
    through the recorder; the calls and their launch counts are unchanged."""
    saved = []
    for name, (mod, attr, key) in _engine_wrappers().items():
        fn = getattr(mod, attr)

        def recorder(*a, _fn=fn, _name=name, _key=key, **kw):
            shape = _key(*a, **kw)
            if a[0].is_cuda and _work(shape) > _work(seen.get(_name, ())):
                seen[_name] = shape
            return _fn(*a, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, recorder)
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def bar_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The largest |err| / (tol + tol |want|): the bar is met below 1."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


# GEMM shapes (m, k, n, n_tiles): the JAX package's kernel-test shapes, then
# rows of x, w or out that are not 16-byte aligned (the element-copy
# instance); K = 4096 with N(0,1) weights is the three-way split's hardest
# case
GEMM_TEST_SHAPES = [(10, 16, 40, 4), (130, 300, 520, 8), (64, 512, 1024, 16)]
GEMM_RAGGED_SHAPES = [(7, 12, 5, 2), (130, 200, 70, 3), (33, 300, 70, 3), (5, 13, 7, 1)]
GEMM_LONG_K = (300, 4096, 256, 2)
# forest shapes (n, d, T, depth): the JAX package's kernel-test shapes, then
# n not a multiple of the row tile, n < 32, T not a multiple of the tree
# chunk, and d = 4096 (rows read from global memory); then the forests of
# retail_q2, simple_q2, analytics_q1, analytics_q2 and analytics_q3
FOREST_TEST_SHAPES = [(20, 8, 4, 3), (150, 16, 10, 5), (64, 29, 25, 6),
                      (1001, 29, 100, 9), (7, 29, 100, 9), (3000, 29, 23, 9),
                      (500, 4096, 30, 9)]
FOREST_WORKLOAD_SHAPES = [(3000, 32, 160, 6), (3000, 40, 50, 6), (3000, 29, 100, 9),
                          (3000, 96, 1, 9), (3000, 128, 100, 9)]


def _offset_view(gen, shape, dtype):
    """A contiguous tensor whose data starts 4 bytes past a 16-byte boundary."""
    numel = shape[0] * shape[1]
    base = _normal(gen, (numel + 4,), dtype=dtype)
    off = 4 // base.element_size()
    view = base[off:off + numel].view(shape)
    assert view.data_ptr() % 16 == 4
    return view


def phase_parity() -> None:
    """Each engine kernel against its plain version at the test shapes."""
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dt = str(dtype)[6:]
        for m, k, n, t in GEMM_TEST_SHAPES + GEMM_RAGGED_SHAPES + [(64, 96, 32, 2)]:
            x, w = _normal(gen, (m, k), dtype=dtype), _normal(gen, (k, n), dtype=dtype)
            kernel_vs_plain(bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t),
                            tol, f"block_matmul {m}x{k}x{n}/{t} {dt}")
        for operand in ("x", "w"):
            x = (_offset_view if operand == "x" else _normal)(gen, (96, 256), dtype=dtype)
            w = (_offset_view if operand == "w" else _normal)(gen, (256, 160), dtype=dtype)
            kernel_vs_plain(bm.block_matmul(x, w, 2), bm_ref.block_matmul(x, w, 2),
                            tol, f"block_matmul {dt}, {operand} 4 bytes off 16")
    m, k, n, t = GEMM_LONG_K
    x, w = _normal(gen, (m, k)), _normal(gen, (k, n))
    got, want = bm.block_matmul(x, w, t), bm_ref.block_matmul(x, w, t)
    kernel_vs_plain(got, want, F32_TOL, f"block_matmul {m}x{k}x{n}/{t} N(0,1) weights")
    long_k = bar_ratio(got, want, F32_TOL)
    print(f"[parity] block_matmul ok: {len(GEMM_TEST_SHAPES)} test shapes, "
          f"{len(GEMM_RAGGED_SHAPES)} ragged shapes, 2 pointer offsets and (64, 96, 32), "
          f"f32 and bf16; {GEMM_LONG_K} N(0,1) f32 largest |err| / bar {long_k:.3f} "
          f"(bar rtol=atol={F32_TOL:g})")

    for m, k, n in [(7, 12, 5), (130, 200, 70), (256, 512, 128), (1, 128, 128),
                    (5, 13, 7), (33, 300, 70)]:
        for act in fd_ref.ACTS:
            x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n)), _normal(gen, (n,))
            kernel_vs_plain(fd.fused_dense(x, w, b, act), fd_ref.fused_dense(x, w, b, act),
                            F32_TOL, f"fused_dense {m}x{k}x{n} {act}")
    for m, k, n in [(64, 96, 32), (7, 12, 5), (130, 200, 70), (256, 512, 128)]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, w, b = (_normal(gen, s, dtype=dtype) for s in ((m, k), (k, n), (n,)))
            kernel_vs_plain(fd.fused_dense(x, w, b, "relu"),
                            fd_ref.fused_dense(x, w, b, "relu"), tol,
                            f"fused_dense {m}x{k}x{n} {dtype}")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        x = _offset_view(gen, (96, 256), dtype)
        w, b = _normal(gen, (256, 160), dtype=dtype), _normal(gen, (160,), dtype=dtype)
        kernel_vs_plain(fd.fused_dense(x, w, b, "gelu"), fd_ref.fused_dense(x, w, b, "gelu"),
                        tol, f"fused_dense {dtype}, x 4 bytes off 16")
    m, k, n, _ = GEMM_LONG_K
    x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n)), _normal(gen, (n,))
    kernel_vs_plain(fd.fused_dense(x, w, b, "identity"),
                    fd_ref.fused_dense(x, w, b, "identity"), F32_TOL,
                    f"fused_dense {m}x{k}x{n} N(0,1) weights")
    try:
        fd.fused_dense(x, w, b, "softmax")
        raise AssertionError("fused_dense accepted softmax")
    except ValueError:
        pass
    print(f"[parity] fused_dense ok: 6 f32 shapes x {len(fd_ref.ACTS)} activations, "
          f"4 shapes f32 + bf16, x 4 bytes off 16 in f32 + bf16, {GEMM_LONG_K[:3]} "
          f"N(0,1) f32, softmax refused (bar rtol=atol={F32_TOL:g}, bf16 {BF16_TOL:g})")

    for n, d, t, depth in FOREST_TEST_SHAPES + FOREST_WORKLOAD_SHAPES:
        args = _forest_inputs(gen, n, d, t, depth)
        kernel_vs_plain(df.forest_predict(*args), df_ref.forest_predict(*args),
                        F32_TOL, f"forest {n}x{d} T={t} D={depth}")
    # x and thresholds on a few integers, so that many compares tie (strict
    # >); then feat out of range on both sides (clamped, as JAX gathers)
    x, feat, thresh, leaf = _forest_inputs(gen, 3000, 29, 40, 9)
    x, thresh = x.round(), thresh.round()
    kernel_vs_plain(df.forest_predict(x, feat, thresh, leaf),
                    df_ref.forest_predict(x, feat, thresh, leaf), F32_TOL, "forest ties")
    feat = torch.randint(-40, 70, feat.shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    kernel_vs_plain(df.forest_predict(x, feat, thresh, leaf),
                    df_ref.forest_predict(x, feat, thresh, leaf), F32_TOL,
                    "forest feat out of range")
    print(f"[parity] decision_forest ok: {len(FOREST_TEST_SHAPES)} test shapes (ragged "
          f"n, n < 32, T not a multiple of the tree chunk, d 4096 from global memory), "
          f"the {len(FOREST_WORKLOAD_SHAPES)} workload forests at "
          f"{FOREST_WORKLOAD_SHAPES[0][0]} rows, ties at the thresholds, feat out of "
          f"range (bar rtol=atol={F32_TOL:g})")


def phase_main_shape_parity(shapes: dict) -> dict:
    """Each engine kernel against its plain version at the largest shape
    the full-size runs gave it, with two repeat calls bit-equal; returns
    max |err| per kernel."""
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    m, k, n, t = shapes["block_matmul"]
    x, w = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5)
    got = bm.block_matmul(x, w, t)
    want = bm_ref.block_matmul(x, w, t)
    errs["block_matmul"] = kernel_vs_plain(got, want, F32_TOL,
                                           f"block_matmul main path {m}x{k}x{n}/{t}")
    ratio = bar_ratio(got, want, F32_TOL)
    for i in range(2):
        kernel_vs_plain(bm.block_matmul(x, w, t), got, 0.0, f"block_matmul repeat {i}")
    print(f"[parity] block_matmul main path {m}x{k}x{n} n_tiles={t} "
          f"max|err|={errs['block_matmul']:.3g}, largest |err| / bar {ratio:.3f} "
          f"(bar rtol=atol={F32_TOL:g}); 2 repeats bit-equal")
    m, k, n, act = shapes["fused_dense"]
    x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5), _normal(gen, (n,))
    got = fd.fused_dense(x, w, b, act)
    want = fd_ref.fused_dense(x, w, b, act)
    errs["fused_dense"] = kernel_vs_plain(got, want, F32_TOL,
                                          f"fused_dense main path {m}x{k}x{n}")
    ratio = bar_ratio(got, want, F32_TOL)
    del want
    for i in range(2):
        kernel_vs_plain(fd.fused_dense(x, w, b, act), got, 0.0, f"fused_dense repeat {i}")
    del x, w, b, got
    torch.cuda.empty_cache()
    print(f"[parity] fused_dense main path {m}x{k}x{n} {act} "
          f"max|err|={errs['fused_dense']:.3g}, largest |err| / bar {ratio:.3f} "
          f"(bar rtol=atol={F32_TOL:g}); 2 repeats bit-equal")
    n, d, t, depth = shapes["decision_forest"]
    args = _forest_inputs(gen, n, d, t, depth)
    got = df.forest_predict(*args)
    errs["decision_forest"] = kernel_vs_plain(got, df_ref.forest_predict(*args), F32_TOL,
                                              "forest main path")
    for i in range(2):
        kernel_vs_plain(df.forest_predict(*args), got, 0.0, f"forest repeat {i}")
    print(f"[parity] decision_forest main path {shapes['decision_forest']} "
          f"({df.forest_tiling(n, d, t, depth, _n_sm())}) "
          f"max|err|={errs['decision_forest']:.3g} (bar rtol=atol={F32_TOL:g}); "
          f"2 repeats bit-equal")
    return errs


def phase_main_path() -> tuple:
    """Returns the launch counts and each workload's reference result."""
    from repro_torch.core.executor import execute, execute_reference
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS
    plans, refs = {}, {}
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        plans[name] = (w, kernel_plan(w.plan, w.catalog))
    reset_launches()
    for name, (w, kplan) in plans.items():
        t0 = time.perf_counter()
        ref = refs[name] = execute_reference(w.plan, w.catalog, device="cpu").canonical()
        out = execute(w.plan, w.catalog, backend="torch", device="cuda").canonical()
        assert_canonical_close(ref, out, f"{name}/torch")
        kout = execute(kplan, w.catalog, device="cuda").canonical()
        assert_canonical_close(out, kout, f"{name}/kernel")
        rows = len(next(iter(out.values())))
        print(f"[main] {name} ok: {rows} rows, torch == reference, "
              f"kernel == torch ({time.perf_counter() - t0:.1f} s)")
    launches = read_launches()
    print("[main] kernels " + json.dumps(launches))
    missing = [k for k in ENGINE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return launches, refs


def phase_full_size(profile) -> dict:
    """Each full-size workload through the kernel path, the torch path and
    the plan ``vanilla_mcts`` chooses under ``profile``: medians of 5 and one
    profiled run each, the decisions costed lowering made for them and its
    host time per ``execute``. Returns the largest operand shape each engine
    kernel got in these runs (the main path's shapes of phases 5a and 7)."""
    from repro_torch.core import costed_lowering, planner
    from repro_torch.core.executor import execute
    from repro_torch.core.lowering import lower
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS
    shapes = {}
    for name, scale in FULL_SIZE:
        w = ALL_WORKLOADS[name](scale=scale, device="cuda")
        kplan = kernel_plan(w.plan, w.catalog)
        out = execute(w.plan, w.catalog, backend="torch", device="cuda").canonical()
        reset_launches()
        with recording_shapes(shapes):
            kout = execute(kplan, w.catalog, device="cuda").canonical()
        launched = read_launches()
        assert_finite(out, name)
        assert_canonical_close(out, kout, f"{name}@{scale}/kernel")
        rows = len(next(iter(out.values())))
        torch_ms = median_run_ms(
            lambda: execute(w.plan, w.catalog, backend="torch", device="cuda"))
        kernel_ms = median_run_ms(lambda: execute(kplan, w.catalog, device="cuda"))
        print(f"[full] {name} scale={scale}: {rows} rows, kernel == torch; "
              f"median of {TIMED_RUNS}: kernel path {kernel_ms:.3f} ms, "
              f"torch path {torch_ms:.3f} ms; launches per run "
              + json.dumps(launched))
        for label, plan, backend in (("kernel path", kplan, None),
                                     ("torch path", w.plan, "torch")):
            low = costed_lowering.lower_costed(plan, w.catalog, profile=profile,
                                               backend=backend)
            # the host time of the lowering each ``execute`` of this plan makes
            low_ms = median_host_ms(lambda: lower(plan, w.catalog, backend=backend,
                                                  profile=profile))
            print(f"[full] {name} scale={scale} {label} lowered by cost: estimated "
                  f"{low.baseline_cost * 1e3:.4f} ms in tree order, {low.cost * 1e3:.4f} ms "
                  f"chosen, {low.candidates_scored} candidates; signature {low.signature}; "
                  f"lowering alone, on the host, median of {TIMED_RUNS}: {low_ms:.3f} ms "
                  f"a call")
        profile_breakdown(f"{name} kernel path",
                          lambda: execute(kplan, w.catalog, device="cuda"))
        profile_breakdown(f"{name} torch path",
                          lambda: execute(w.plan, w.catalog, backend="torch",
                                          device="cuda"))
        # the search under the workload's memory budget (the JAX package's
        # setting, sized for scale 1.0) and under none (the card's 80 GB)
        for budget in (w.memory_budget, None):
            cost_fn = planner.analytic_cost_fn(w.catalog, profile, memory_budget=budget)
            oplan, stats = planner.timed(planner.optimize_vanilla_mcts, w.plan, w.catalog,
                                         cost_fn=cost_fn, iterations=MCTS_ITERATIONS,
                                         seed=0)
            reset_launches()
            with recording_shapes(shapes):
                oout = execute(oplan, w.catalog, device="cuda").canonical()
            opt_launches = read_launches()
            assert_canonical_close(out, oout, f"{name}@{scale}/optimized")
            opt_ms = median_run_ms(lambda: execute(oplan, w.catalog, device="cuda"))
            label = f"budget {budget:.3g} B" if budget else "no budget"
            print(f"[full] {name} scale={scale} optimized (vanilla_mcts, {MCTS_ITERATIONS} "
                  f"iterations, seed 0, {profile.name} prior, {label}): == torch path; "
                  f"estimated speedup {stats['speedup']:.3f}x, optimizer "
                  f"{stats['opt_seconds']:.3f} s; median of {TIMED_RUNS}: {opt_ms:.3f} ms "
                  f"(kernel path {kernel_ms:.3f} ms, torch path {torch_ms:.3f} ms); "
                  f"launches per run {json.dumps(opt_launches)}")
            profile_breakdown(f"{name} optimized plan, {label}",
                              lambda: execute(oplan, w.catalog, device="cuda"))
        del w, kplan, oplan
        torch.cuda.empty_cache()
    missing = [k for k in ENGINE_KERNELS if k not in shapes]
    if missing:
        raise AssertionError(f"kernels not launched on the full-size runs: {missing}")
    print("[full] largest operand shape per kernel " + json.dumps(shapes))
    return shapes


# ---------------------------------------------------------------------------
# the optimizer: cost profile, costed lowering, plan search
# ---------------------------------------------------------------------------

STRATEGIES = ("unoptimized", "heuristic", "greedy", "vanilla_mcts")
MCTS_ITERATIONS = 40
DISPATCH_SCALE = 0.05  # workloads whose device work is far below the host's


def _phys_nodes(node):
    yield node
    for c in node.children():
        yield from _phys_nodes(c)


def _expr_calls(e):
    from repro_torch.core import ir
    if isinstance(e, ir.Call):
        yield e
    for c in e.children():
        yield from _expr_calls(c)


def expected_kernels(pplan) -> set:
    """The engine kernels a physical plan launches: BlockedMatmul and
    ForestRelational nodes realized fused on the kernel backend, and the
    fused_dense and forest atoms set to the kernel by R4-2 in the
    functions its expressions call."""
    from repro_torch.core import physical as ph
    kernels, calls = set(), []
    for node in _phys_nodes(pplan.root):
        if isinstance(node, ph.PBlockedMatmul) and node.mode == "fused" \
                and node.backend == "kernel":
            kernels.add("block_matmul")
        if isinstance(node, ph.PForestRelational) and node.mode == "fused" \
                and node.backend == "kernel":
            kernels.add("decision_forest")
        for st in getattr(node, "stages", ()):
            exprs = [e for _, e in st.outputs] if isinstance(st, ph.ProjectStage) else \
                [st.pred] if isinstance(st, ph.FilterStage) else []
            calls += [c for e in exprs for c in _expr_calls(e)]
    for call in calls:
        graph = pplan.registry.get(call.fn).graph
        for n in (graph.nodes if graph else ()):
            if n.atom.backend == "kernel":
                kernels.add({"fused_dense": "fused_dense",
                             "forest": "decision_forest"}[n.atom.kind])
    return kernels


def measure_dispatch(profile) -> tuple:
    """Host time of one small eager torch operator on the card, and of one
    relational operator as the cost model counts them (``n_ops``): the
    median over the 12 workloads at a small scale of a tree-order plan's
    wall time over its operator count."""
    from repro_torch.core import cost
    from repro_torch.core import physical as ph
    from repro_torch.core.lowering import lower
    from repro_torch.data.workloads import ALL_WORKLOADS
    x = torch.zeros(1024, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    op_s = (time.perf_counter() - t0) / n
    per_op = []
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=DISPATCH_SCALE, device="cuda")
        pplan = lower(w.plan, w.catalog, costed=False)
        n_ops = cost.plan_cost_breakdown(pplan, w.catalog, profile).n_ops
        tables = dict(w.catalog.tables)
        ph.run(pplan, tables)
        torch.cuda.synchronize()
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            ph.run(pplan, tables)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        per_op.append(statistics.median(times) / n_ops)
    return op_s, statistics.median(per_op)


def _open_sites(plan, catalog):
    """R3-1 and R3-2 on every call they reach with their annotations
    dropped, so that costed lowering chooses each node's realization."""
    import dataclasses
    from repro_torch.core.rules import ALL_RULES
    for rule in ("R3-1", "R3-2"):
        while True:
            cfgs = ALL_RULES[rule].configs(plan, catalog)
            if not cfgs:
                break
            plan = ALL_RULES[rule].apply(plan, catalog, cfgs[0])
    return dataclasses.replace(plan, phys={})


def phase_lower() -> "object":
    """[lower]: the detected profile (the H100 prior on an H100), the
    dispatch it was set from, and costed lowering of the 12 workloads at
    scale 1.0 under it: as built, and with R3-1/R3-2 applied and their
    realizations left open. Returns the profile."""
    from repro_torch.core import cost, costed_lowering
    from repro_torch.core import physical as ph
    from repro_torch.data.workloads import ALL_WORKLOADS
    profile = cost.DeviceProfile.detect("cuda")
    if torch.cuda.get_device_capability(0) == (9, 0) and profile != cost.H100_PROFILE:
        raise AssertionError(f"detect('cuda') on an H100 gave {profile.signature()}")
    op_s, rel_s = measure_dispatch(profile)
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    print(f"[lower] profile {profile.signature()} supports_kernel={profile.supports_kernel}; "
          f"measured here: one eager torch op {op_s * 1e6:.2f} us, one relational operator "
          f"{rel_s * 1e6:.2f} us (median over the 12 workloads at scale {DISPATCH_SCALE}, "
          f"tree-order plans, wall / n_ops) against the prior's op_overhead_s "
          f"{profile.op_overhead_s * 1e6:.2f} us; clocks.max.sm {max_mhz:g} MHz, shared "
          f"memory {_n_sm()} SMs x 128 B x clock = {_n_sm() * 128 * max_mhz * 1e6:.4e} B/s "
          f"against the prior's vmem_bw {profile.vmem_bw:.4e}")
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        for label, plan in (("plan", w.plan), ("r3 open", _open_sites(w.plan, w.catalog))):
            low = costed_lowering.lower_costed(plan, w.catalog, profile=profile)
            ml = [n for n in _phys_nodes(low.plan.root)
                  if isinstance(n, (ph.PBlockedMatmul, ph.PForestRelational))]
            kernel_sites = sum(n.backend == "kernel" for n in ml)
            print(f"[lower] {name} {label}: tree order {low.baseline_cost * 1e3:.4f} ms, "
                  f"chosen {low.cost * 1e3:.4f} ms ({low.baseline_cost / low.cost:.3f}x), "
                  f"{low.candidates_scored} candidates scored, {kernel_sites} of {len(ml)} "
                  f"mode/backend sites chose kernel "
                  f"({', '.join(f'{n.mode}/{n.backend}' for n in ml) or 'none'}); "
                  f"signature {low.signature}")
    return profile


def phase_plan(profile, refs: dict) -> dict:
    """[plan]: the four strategies on the 12 workloads at scale 1.0 under
    the detected profile and each workload's memory budget; every chosen
    plan executed on the card against the CPU reference. Launch counts
    are read around each search (the compact rule counts rows by running
    filter subtrees) and around each plan's execution, where each kernel
    the plan names must run; ``[main] optimizer kernels`` sums the
    executions' counts, and the searches' are printed beside it."""
    from repro_torch.core import planner
    from repro_torch.core.executor import execute
    from repro_torch.core.lowering import lower
    from repro_torch.data.workloads import ALL_WORKLOADS
    executed = dict.fromkeys(KERNELS, 0)
    searched = dict.fromkeys(KERNELS, 0)
    reset_launches()
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        cost_fn = planner.analytic_cost_fn(w.catalog, profile, memory_budget=w.memory_budget)
        for strategy in STRATEGIES:
            before = read_launches()
            plan, stats = planner.timed(planner.STRATEGIES[strategy], w.plan, w.catalog,
                                        cost_fn=cost_fn, memory_budget=w.memory_budget,
                                        iterations=MCTS_ITERATIONS, seed=0)
            mid = read_launches()
            out = execute(plan, w.catalog, device="cuda").canonical()
            after = read_launches()
            assert_canonical_close(refs[name], out, f"{name}/{strategy}")
            ran = {k: after[k] - mid[k] for k in after}
            want = expected_kernels(lower(plan, w.catalog, profile=profile))
            idle = sorted(k for k in want if ran[k] <= 0)
            if idle:
                raise AssertionError(f"{name}/{strategy}: plan names {sorted(want)}, "
                                     f"{idle} not launched")
            search = {k: mid[k] - before[k] for k in mid if mid[k] > before[k]}
            for k in KERNELS:
                executed[k] += ran[k]
                searched[k] += mid[k] - before[k]
            print(f"[plan] {name} {strategy}: estimated speedup "
                  f"{cost_fn(w.plan) / cost_fn(plan):.3f}x, optimizer "
                  f"{stats['opt_seconds']:.3f} s, == reference; kernel launches "
                  f"executing it {json.dumps(ran)}"
                  + (f", counting rows in the search {json.dumps(search)}" if search else ""))
    print("[main] optimizer kernels " + json.dumps(executed)
          + "; launched by the searches' row counts " + json.dumps(searched))
    return executed


# ---------------------------------------------------------------------------
# the learned embeddings and the reusable search on them
# ---------------------------------------------------------------------------

EMBED_TOL = 1e-4  # the card's embeddings against the CPU's, the same weights
EMBED_RUNS = 20  # timed embed misses
# benchmarks/optimizers.py: _train_embedder's recipe and run()'s Table IV fleet
TRAIN_STEPS, TRAIN_QUERIES, TRAIN_GRAPHS = 120, 60, 40
FLEET_ID, FLEET_OOD, FLEET_ITERATIONS, FLEET_SCALE = 40, 20, 20, 0.5
CORR_BAR = 0.5  # tests/test_embedding.py: the latency head ranks the plans


def phase_embed() -> None:
    """[embed]: an untrained embedder (seed 0) on the card and the same
    weights on the CPU embed the 12 workloads (scale 1.0) and the 20
    templates (scale 0.5) alike; one embed miss timed captured and eager."""
    from repro_torch.core import embedding as E
    from repro_torch.core import optimizer as om
    from repro_torch.data import templates
    from repro_torch.data.workloads import ALL_WORKLOADS
    card = om.init_embedder(0)
    cpu = om.init_embedder(0, device="cpu")
    for dst, src in zip(cpu.modules(), card.modules()):
        dst.load_state_dict({k: v.cpu() for k, v in src.state_dict().items()})
    queries = []
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        queries.append((name, w.plan, w.catalog))
    for t in sorted(templates.TEMPLATES):
        queries.append((f"template {t}",) + templates.sample_query(
            t, seed=50 + t, scale=FLEET_SCALE, device="cuda"))
    t0 = time.perf_counter()
    worst = worst_lat = 0.0
    # the embedder turns TF32 off itself: hold it to the CPU with TF32 on
    torch.backends.cuda.matmul.allow_tf32 = True
    for label, plan, cat in queries:
        got, want = card.embed(plan, cat), cpu.embed(plan, cat)
        if not (np.isfinite(got).all() and abs(float(np.linalg.norm(got)) - 1.0) < 1e-4):
            raise AssertionError(f"[embed] {label}: not a finite unit vector")
        worst = max(worst, kernel_vs_plain(torch.from_numpy(got), torch.from_numpy(want),
                                           EMBED_TOL, f"[embed] {label}"))
        lat, lat_cpu = card.predict_latency(plan, cat), cpu.predict_latency(plan, cat)
        if not abs(lat - lat_cpu) <= EMBED_TOL * (1 + abs(lat_cpu)):
            raise AssertionError(f"[embed] {label}: latency {lat} on the card, {lat_cpu} on the CPU")
        worst_lat = max(worst_lat, abs(lat - lat_cpu))
    torch.backends.cuda.matmul.allow_tf32 = False
    for _, plan, cat in queries:
        card.embed(plan, cat)
    stats = card.cache_stats.as_dict()
    print(f"[embed] untrained embedder (seed 0), 393-d, {len(queries)} plans (12 workloads "
          f"at scale 1.0, 20 templates at scale {FLEET_SCALE}): card == CPU, max|err| "
          f"{worst:.3g} (bar rtol=atol={EMBED_TOL:g}; the caller's TF32 on), unit norm, no "
          f"NaN; predicted latency "
          f"max|err| {worst_lat:.3g}; a second pass hits the cache: hits {stats['hits']}, "
          f"misses {stats['misses']} ({time.perf_counter() - t0:.1f} s)")

    _, plan, cat = queries[0]
    pf = E.featurize_plan(plan, cat)

    def miss():
        card._cache.clear()
        card.embed(plan, cat)

    def eager():
        arrays = tuple(torch.from_numpy(a)[None].to("cuda")
                       for a in E.pf_to_arrays(E.featurize_plan(plan, cat)))
        with torch.no_grad(), E.no_tf32():
            card.forward("embed", arrays)[0].cpu().numpy()

    featurize_ms = median_host_ms(lambda: E.featurize_plan(plan, cat), runs=EMBED_RUNS)
    captured_ms = median_host_ms(miss, runs=EMBED_RUNS)
    eager_ms = median_host_ms(eager, runs=EMBED_RUNS)
    graph = card._graphs["embed"]
    replay_ms = cuda_ms(graph.replay, reps=50)
    arrays = tuple(torch.from_numpy(a)[None].to("cuda") for a in E.pf_to_arrays(pf))
    with torch.no_grad(), E.no_tf32():
        eager_device_ms = cuda_ms(lambda: card.forward("embed", arrays), reps=50)
    print(f"[embed] one embed miss ({queries[0][0]}), host clock, median of {EMBED_RUNS}: "
          f"captured {captured_ms:.3f} ms, eager {eager_ms:.3f} ms, featurize_plan alone "
          f"{featurize_ms:.3f} ms; the forward alone, CUDA events over 50 calls: graph "
          f"replay {replay_ms:.4f} ms, eager {eager_device_ms:.4f} ms; capture "
          f"{graph.capture_s * 1e3:.1f} ms, pool {graph.pool_bytes / 2**20:.1f} MiB")


def train_embedder(seed: int, one_model: bool, profile):
    """benchmarks/optimizers.py's _train_embedder on the card: Model2Vec over
    the sampled models' graphs, Query2Vec over in-distribution template
    queries at scale 0.5, then the latency head (two-model or one-model) on
    the analytic costs under ``profile``. Returns the embedder and its
    numbers."""
    from repro_torch.core import optimizer as om
    from repro_torch.core import planner
    from repro_torch.data import templates
    from repro_torch.mlfuncs import builders
    emb = om.init_embedder(seed)
    ind, _ = templates.ood_split()
    graphs = [g for g in (builders.sample_model(s).graph for s in range(TRAIN_GRAPHS))
              if g is not None]
    rng = np.random.default_rng(seed)
    plans, cats, costs = [], [], []
    for i in range(TRAIN_QUERIES):
        t = ind[int(rng.integers(0, len(ind)))]
        p, c = templates.sample_query(t, seed=10_000 + i, scale=FLEET_SCALE, device="cuda")
        plans.append(p)
        cats.append(c)
        costs.append(planner.analytic_cost_fn(c, profile)(p))
    runs = {}
    for name, steps, fn in (
            ("model2vec", TRAIN_STEPS, lambda: om.train_model2vec(
                emb, graphs, steps=TRAIN_STEPS, batch=8, lr=1e-4)),
            ("query2vec", TRAIN_STEPS, lambda: om.train_query2vec(
                emb, plans, cats, steps=TRAIN_STEPS, batch=8)),
            ("latency", 2 * TRAIN_STEPS, lambda: om.train_latency(
                emb, plans, cats, costs, steps=2 * TRAIN_STEPS, batch=12,
                one_model=one_model))):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        r["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
        if not (np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"])):
            raise AssertionError(f"[train] seed {seed} {name}: loss not finite {r}")
        runs[name] = r
    pred = np.array([emb.predict_latency(p, c) for p, c in zip(plans, cats)])
    runs["q_error"] = float(np.median(om.q_error(pred, np.array(costs))))
    runs["corr"] = float(np.corrcoef(np.log(pred + 1e-12), np.log(costs))[0, 1])
    return emb, runs


def phase_train(profile) -> dict:
    """[train]: the two-model (seed 0) and one-model (seed 1) embedders of
    benchmarks/optimizers.py, trained on the card."""
    trained = {}
    for label, seed, one_model in (("two-model", 0, False), ("one-model", 1, True)):
        t0 = time.perf_counter()
        emb, runs = train_embedder(seed, one_model, profile)
        steps = "; ".join(f"{k} {r['loss_first']:.4f} -> {r['loss_last']:.4f}, "
                          f"{r['ms_per_step']:.2f} ms/step"
                          for k, r in runs.items() if isinstance(r, dict))
        print(f"[train] {label} (seed {seed}; {TRAIN_GRAPHS} sampled models, "
              f"{TRAIN_QUERIES} template queries at scale {FLEET_SCALE}, {TRAIN_STEPS}/"
              f"{TRAIN_STEPS}/{2 * TRAIN_STEPS} steps; analytic costs under {profile.name}): "
              f"{steps}; median q-error {runs['q_error']:.3f}, log-correlation "
              f"{runs['corr']:.3f} ({time.perf_counter() - t0:.1f} s)")
        trained[label] = (emb, runs)
    corr = trained["two-model"][1]["corr"]
    if not corr > CORR_BAR:
        raise AssertionError(f"[train] two-model log-correlation {corr} <= {CORR_BAR}")
    return {k: emb for k, (emb, _) in trained.items()}


def _fleet():
    """benchmarks/optimizers.py's Table IV fleet on the card: 40
    in-distribution and 20 out-of-distribution template queries."""
    from repro_torch.data import templates
    ind, ood = templates.ood_split()
    rng = np.random.default_rng(7)
    fleet = []
    for split, n, pool, base in (("ID", FLEET_ID, ind, 20_000), ("OOD", FLEET_OOD, ood, 30_000)):
        for i in range(n):
            t = pool[int(rng.integers(0, len(pool)))]
            fleet.append((split,) + templates.sample_query(t, seed=base + i, scale=FLEET_SCALE,
                                                           device="cuda"))
    return fleet


def phase_reusable(profile, embedders: dict) -> None:
    """[reuse]: Table IV's fleet through ReusableMCTS on each trained
    embedder and through VanillaMCTS; every chosen plan executed on the card
    against the reference interpreter on the CPU."""
    from repro_torch.core import planner
    from repro_torch.core.executor import execute, execute_reference
    from repro_torch.core.mcts import ReusableMCTS
    t0 = time.perf_counter()
    fleet = _fleet()
    refs = [execute_reference(plan, cat, device="cpu").canonical() for _, plan, cat in fleet]
    cost_fn_factory = lambda cat: planner.analytic_cost_fn(cat, profile)  # noqa: E731
    searchers = {"vanilla_mcts": None}
    for label, emb in embedders.items():
        searchers[f"reusable {label}"] = ReusableMCTS(
            catalog_fn=None, embed_fn=emb.embed, cost_fn_factory=cost_fn_factory,
            iterations=FLEET_ITERATIONS, warm_iterations=max(FLEET_ITERATIONS // 4, 4),
            sim_threshold=0.98, seed=0)
    for label, search in searchers.items():
        by_split = {"ID": [0.0, 0.0, 0, 0], "OOD": [0.0, 0.0, 0, 0]}
        for i, (split, plan, cat) in enumerate(fleet):
            cost_fn = cost_fn_factory(cat)
            t1 = time.perf_counter()
            if search is None:
                best, stats = planner.optimize_vanilla_mcts(plan, cat, cost_fn=cost_fn,
                                                            iterations=FLEET_ITERATIONS)
            else:
                best, stats = search.optimize(plan, cat)
            acc = by_split[split]
            acc[0] += time.perf_counter() - t1
            acc[1] += cost_fn(best)
            acc[2] += int(bool(stats.get("collision")))
            acc[3] += 1
            assert_canonical_close(refs[i], execute(best, cat, device="cuda").canonical(),
                                   f"[reuse] {label} query {i}")
        parts = ", ".join(f"{split} {n} queries: opt {opt_s:.3f} s, estimated exec "
                          f"{exec_s:.6f} s"
                          + ("" if search is None else f", collision rate {coll / n:.3f}")
                          for split, (opt_s, exec_s, coll, n) in by_split.items())
        store = ("" if search is None else
                 f"; node store {len(search.nodes)} nodes, {search.storage_bytes()} bytes")
        print(f"[reuse] {label}, {FLEET_ITERATIONS} iterations: {parts}{store}")
    stats = {k: e.cache_stats.as_dict() for k, e in embedders.items()}
    print(f"[reuse] Table IV fleet ({FLEET_ID} ID + {FLEET_OOD} OOD template queries at "
          f"scale {FLEET_SCALE}, benchmarks/optimizers.py), {profile.name} prior: every "
          f"chosen plan executed on the card == the reference interpreter on the CPU; "
          f"embedding caches {json.dumps(stats)} ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# the compiled-plan cache, the serving tier and its feedback channel
# ---------------------------------------------------------------------------

CACHE_CALLS = 5  # fresh instances through each captured executable
SERVING_SCALE = 0.08  # benchmarks/serving_bench.py's traffic
SERVING_BATCHES = (1, 2, 4, 8, 16)
MIX_QUERIES, MIX_RATIO, MIX_REQUESTS, MIX_BATCH = (
    ("simple_q1", "simple_q2", "simple_q3"), (4, 2, 1), 42, 8)
MIX_RUNS = 3
FULL_WIDTH_BATCH = 4  # analytics_q1@100 instances in one micro-batch
BATCHED_TOL = 2e-5  # tests/test_serving_batched.py: batched against sequential
FALLBACK = "performance drop"  # vmap's warning when an op has no batching rule


@contextlib.contextmanager
def counting(module, attr: str, calls: list, key=lambda *a, **kw: None):
    """Inside it, ``module.attr`` appends ``key(*args)`` to ``calls`` at each
    call and then runs as before."""
    fn = getattr(module, attr)

    def counted(*a, **kw):
        calls.append(key(*a, **kw))
        return fn(*a, **kw)
    setattr(module, attr, counted)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


@contextlib.contextmanager
def vmap_fallbacks(seen: set):
    """Inside it, vmap warns when an op takes its per-example fallback (no
    batching rule); the ops' warnings land in ``seen``."""
    import warnings
    from torch._C._functorch import _set_vmap_fallback_warning_enabled
    _set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            yield seen
    finally:
        _set_vmap_fallback_warning_enabled(False)
        seen.update(str(r.message)[:160] for r in rec if FALLBACK in str(r.message))


def _block(results):
    """``results`` once the card has finished them."""
    torch.cuda.synchronize()
    return results


def _catalog_of(tables: dict):
    from repro_torch.core import ir
    cat = ir.Catalog()
    for name, t in tables.items():
        cat.add(name, t)
    return cat


def assert_tables_close(got, want, tol: float, label: str) -> None:
    """Two result Tables row for row: masks exact, columns at rtol=atol=tol."""
    if set(got.columns) != set(want.columns) or not torch.equal(got.valid, want.valid):
        raise AssertionError(f"{label}: schemas or masks differ")
    for k in want.columns:
        torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol,
                                   msg=lambda m, k=k: f"{label}:{k}: {m}")


def phase_cache() -> None:
    """[cache]: analytics_q1@100 and rec_q3@20 through ``compile_plan`` on
    their kernel and torch plans: the build split into lowering, warm-up and
    capture; 5 calls on fresh instances, each == ``execute`` on the same
    instance at the bar, with one capture and one lowering; the median call
    (CUDA events around the input copy, the replay and the output clone)
    beside ``execute``'s median; the kernels in each graph (counted at
    capture) and each graph's pool."""
    from repro_torch.core import costed_lowering
    from repro_torch.core.executor import compile_plan, execute
    from repro_torch.core.plan_cache import GLOBAL_PLAN_CACHE as gpc, PlanCache
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS, rolled_instances
    reset_launches()
    on_path = dict.fromkeys(KERNELS, 0)  # the executables' launches alone
    for name, scale in FULL_SIZE:
        w = ALL_WORKLOADS[name](scale=scale, device="cuda")
        instances = rolled_instances(dict(w.catalog.tables), CACHE_CALLS + 1)[1:]
        for label, plan, backend in (("kernel plan", kernel_plan(w.plan, w.catalog), None),
                                     ("torch plan", w.plan, "torch")):
            cache = PlanCache(device="cuda")
            lowered = []
            with counting(costed_lowering, "lower_costed", lowered):
                t0 = time.perf_counter()
                run = cache.get_or_compile(plan, w.catalog, backend=backend)
                lower_s = time.perf_counter() - t0
                before = read_launches()
                _block(run(dict(w.catalog.tables)))
                built = read_launches()
                outs, call_ms = [], []
                for tabs in instances:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    outs.append(run(tabs))
                    end.record()
                    torch.cuda.synchronize()
                    call_ms.append(start.elapsed_time(end))
                replayed = read_launches()
            if cache.traces != 1 or len(lowered) != 1 or replayed != built:
                raise AssertionError(f"[cache] {name}/{label}: traces {cache.traces}, "
                                     f"lowerings {len(lowered)}, replays launched "
                                     f"{replayed} after {built}")
            for k in on_path:
                on_path[k] += replayed[k] - before[k]
            for i, (tabs, out) in enumerate(zip(instances, outs)):
                want = execute(plan, _catalog_of(tabs), backend=backend, device="cuda")
                assert_canonical_close(want.canonical(), out.canonical(),
                                       f"[cache] {name}@{scale} {label} instance {i}")
            exec_ms = median_run_ms(lambda: execute(plan, w.catalog, backend=backend,
                                                    device="cuda"))
            cap = run.captured
            if cap is None:
                raise AssertionError(f"[cache] {name}/{label}: no graph was captured")
            in_graph = {k: (built[k] - before[k]) // 2 for k in built
                        if built[k] > before[k]}
            print(f"[cache] {name} scale={scale} {label}: built in {lower_s:.4f} s "
                  f"lowering + {cap.warmup_s:.4f} s warm-up + {cap.capture_s:.4f} s "
                  f"capture; graph pool {cap.pool_bytes / 2 ** 20:.1f} MiB; "
                  f"{CACHE_CALLS} fresh instances == execute, traces {cache.traces}, "
                  f"lowering {len(lowered)}x; median call {statistics.median(call_ms):.3f} ms "
                  f"(CUDA events around copy in, replay, clone out; calls "
                  f"{', '.join(f'{m:.3f}' for m in call_ms)}) against execute "
                  f"{exec_ms:.3f} ms (median of {TIMED_RUNS}); kernels in the graph "
                  f"{json.dumps(in_graph)} (launch counts rise at warm-up and at "
                  f"capture, never at replay)")
            del outs, run, cache
        # compile_plan goes through the global cache: one build, then hits
        kplan = kernel_plan(w.plan, w.catalog)
        traces, before = gpc.traces, read_launches()
        first = compile_plan(kplan, w.catalog)().canonical()
        again = compile_plan(kplan, w.catalog)().canonical()
        for k, n in read_launches().items():
            on_path[k] += n - before[k]
        assert_canonical_close(first, again, f"[cache] {name} compile_plan")
        if gpc.traces != traces + 1:
            raise AssertionError(f"[cache] {name}: compile_plan built {gpc.traces - traces}x")
        gpc._cache.clear()
        del w, instances
        torch.cuda.empty_cache()
    print(f"[main] cache kernels {json.dumps(on_path)} (the executables' own: "
          f"capture-time counts, each kernel of a graph counted at its warm-up and at "
          f"its capture; the eager runs they are checked against are left out)")
    missing = [k for k in ENGINE_KERNELS if on_path[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not captured on the cache path: {missing}")


def phase_serving() -> tuple:
    """[serving]: benchmarks/serving_bench.py's traffic through the kernel
    plans on the card (scaling sweep, the 42-request mix against a batch-1
    server), then one micro-batch of 4 analytics_q1@100 instances; every
    batched result against its sequential one. Returns the mix's batched
    server and the cache it shares."""
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS, roll_tables, rolled_instances
    from repro_torch.kernels.decision_forest import ops as df
    from repro_torch.serving import QueryServer
    reset_launches()
    fallbacks: set = set()
    for name in ("simple_q2", "simple_q3"):
        w = ALL_WORKLOADS[name](scale=SERVING_SCALE, device="cuda")
        plan = kernel_plan(w.plan, w.catalog)
        cache = PlanCache(device="cuda")
        run_seq = cache.get_or_compile(plan, w.catalog)
        parts = []
        for b in SERVING_BATCHES:
            tabs = tuple(rolled_instances(dict(w.catalog.tables), b))
            seq = [_block(run_seq(t)) for t in tabs]
            run_bat = cache.get_or_compile_batched(plan, w.catalog, b)
            with vmap_fallbacks(fallbacks):
                outs = _block(run_bat(tabs))
            for i, (o, s) in enumerate(zip(outs, seq)):
                assert_tables_close(o, s, BATCHED_TOL, f"[serving] {name} B={b} query {i}")
            seq_ms = median_host_ms(lambda: [_block(run_seq(t)) for t in tabs])
            bat_ms = median_host_ms(lambda: _block(run_bat(tabs)))
            parts.append(f"B={b} sequential {seq_ms:.3f} ms, batched {bat_ms:.3f} ms "
                         f"({seq_ms / bat_ms:.2f}x)")
        print(f"[serving] {name} scale={SERVING_SCALE} kernel plan, host clock around "
              f"dispatches that end in a synchronize, median of {TIMED_RUNS}: "
              + "; ".join(parts) + f"; batched == sequential at {BATCHED_TOL:g}, "
              f"traces {cache.traces}")

    built = {n: ALL_WORKLOADS[n](scale=SERVING_SCALE, device="cuda") for n in MIX_QUERIES}
    plans = {n: kernel_plan(w.plan, w.catalog) for n, w in built.items()}
    order = []
    while len(order) < MIX_REQUESTS:
        for n, k in zip(MIX_QUERIES, MIX_RATIO):
            order.extend([n] * k)
    payloads = [(plans[n], built[n].catalog, roll_tables(dict(built[n].catalog.tables), i))
                for i, n in enumerate(order[:MIX_REQUESTS])]

    def serve_all(server):
        t0 = time.perf_counter()
        reqs = []
        for plan, catalog, tabs in payloads:
            reqs.append(server.submit(plan, catalog, tabs))
            server.step()  # size-triggered dispatch of any full group
        server.drain()
        return time.perf_counter() - t0, reqs

    shared = PlanCache(device="cuda")

    def measure(make):
        with vmap_fallbacks(fallbacks):
            serve_all(make())  # builds every (signature, batch size) of the run
        runs = [(serve_all(srv), srv) for srv in (make() for _ in range(MIX_RUNS))]
        runs.sort(key=lambda r: r[0][0])
        (secs, reqs), srv = runs[len(runs) // 2]
        return secs, reqs, srv

    bat_s, bat_reqs, bat_srv = measure(
        lambda: QueryServer(cache=shared, max_batch_size=MIX_BATCH, max_wait_s=3600.0))
    seq_s, seq_reqs, _ = measure(
        lambda: QueryServer(cache=shared, max_batch_size=1, max_wait_s=0.0))
    done = [r for r in bat_reqs if r.done and r.error is None]
    if len(done) != MIX_REQUESTS:
        raise AssertionError(f"[serving] mix: {len(done)} of {MIX_REQUESTS} served")
    for i, (b, s) in enumerate(zip(bat_reqs, seq_reqs)):
        assert_tables_close(b.result, s.result, BATCHED_TOL, f"[serving] mix request {i}")
    st = bat_srv.stats()
    print(f"[serving] mix of {MIX_REQUESTS} requests over {'/'.join(MIX_QUERIES)} "
          f"{':'.join(map(str, MIX_RATIO))} at scale {SERVING_SCALE}, kernel plans, "
          f"QueryServer(max_batch_size={MIX_BATCH}): {len(done)} of {MIX_REQUESTS} served, "
          f"each == its batch-1 result; {MIX_REQUESTS / bat_s:.1f} queries/s against "
          f"{MIX_REQUESTS / seq_s:.1f} at batch 1 ({seq_s / bat_s:.2f}x; host clock, "
          f"median of {MIX_RUNS} warm runs); {st['dispatches']} dispatches, "
          f"{st['groups_formed']} groups, mean occupancy {st['mean_occupancy']:.2f}, "
          f"signatures {st['signatures']}")

    name, scale = FULL_SIZE[0]
    w = ALL_WORKLOADS[name](scale=scale, device="cuda")
    plan = kernel_plan(w.plan, w.catalog)
    cache = PlanCache(device="cuda")
    tabs = tuple(rolled_instances(dict(w.catalog.tables), FULL_WIDTH_BATCH))
    run_seq = cache.get_or_compile(plan, w.catalog)
    seq = [_block(run_seq(t)) for t in tabs]
    run_bat = cache.get_or_compile_batched(plan, w.catalog, FULL_WIDTH_BATCH)
    rows = []
    with vmap_fallbacks(fallbacks), counting(df, "launch", rows, lambda x, *a: x.shape[0]):
        outs = _block(run_bat(tabs))
        replay = _block(run_bat(tabs))
    for i, (o, r, s) in enumerate(zip(outs, replay, seq)):
        assert_tables_close(o, s, BATCHED_TOL, f"[serving] {name}@{scale} x{FULL_WIDTH_BATCH} {i}")
        assert_tables_close(r, s, BATCHED_TOL, f"[serving] {name}@{scale} replay {i}")
    if len(rows) != 2 or len(set(rows)) != 1:
        raise AssertionError(f"[serving] {name}@{scale} x{FULL_WIDTH_BATCH}: forest launches "
                             f"with rows {rows}, want one at warm-up and one at capture")
    seq_ms = median_host_ms(lambda: [_block(run_seq(t)) for t in tabs])
    bat_ms = median_host_ms(lambda: _block(run_bat(tabs)))
    print(f"[serving] {name} scale={scale} x{FULL_WIDTH_BATCH} in one micro-batch: the "
          f"forest kernel launched once over {rows[0]:,} rows (warm-up and capture; "
          f"{rows[0] // FULL_WIDTH_BATCH:,} a query); == {FULL_WIDTH_BATCH} sequential calls "
          f"at {BATCHED_TOL:g}; batched {bat_ms:.3f} ms against sequential {seq_ms:.3f} ms "
          f"(host clock, median of {TIMED_RUNS})")
    del w, seq, outs, replay, run_bat, run_seq, cache
    torch.cuda.empty_cache()
    kernel_ops = sorted(f for f in fallbacks if "repro_torch" in f)
    print(f"[serving] vmap per-example fallbacks: {sorted(fallbacks) or 'none'}")
    if kernel_ops:
        raise AssertionError(f"engine kernels on vmap's fallback: {kernel_ops}")
    launches = read_launches()
    print(f"[main] serving kernels {json.dumps(launches)} (capture-time counts)")
    missing = [k for k in ("decision_forest", "fused_dense") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")
    return bat_srv, shared


def phase_feedback(server, cache) -> None:
    """[feedback]: ``calibrate_profile`` on the mix's signature statistics
    against the H100 prior, then ``apply_calibration`` on the server's cache
    and the signatures whose lowering decisions changed. Printed only: the
    prior in ``core/cost.py`` stays."""
    from repro_torch.serving import feedback
    exports = feedback.export_signature_stats(server)
    prior = cache.profile
    fit = feedback.calibrate_profile(exports, prior)
    p = fit.profile
    print(f"[feedback] calibrate_profile over {fit.n_samples} signatures of the mix "
          f"(mean dispatch s {', '.join(f'{e.mean_dispatch_s:.6f}' for e in exports)}; "
          f"occupancy {', '.join(f'{e.mean_occupancy:.2f}' for e in exports)}): "
          f"op_overhead_s {p.op_overhead_s:.4e} (prior {prior.op_overhead_s:.4e}), "
          f"peak_flops {p.peak_flops:.4e} (prior {prior.peak_flops:.4e}), hbm_bw "
          f"{p.hbm_bw:.4e} (prior {prior.hbm_bw:.4e}); relative error of the "
          f"prediction {fit.mape_before:.3f} before, {fit.mape_after:.3f} after")
    before = [e.key for e in exports]
    feedback.apply_calibration(cache, exports)
    after = [cache.key(e.plan, e.catalog) for e in exports]
    changed = sum(a.split("#cl=")[1] != b.split("#cl=")[1] for a, b in zip(after, before))
    print(f"[feedback] apply_calibration: profile epoch {cache.profile_epoch}, "
          f"{changed} of {len(before)} signatures' #cl= decisions changed (the fit is "
          f"printed, not installed in core/cost.py)")


def _attn_inputs(gen, b, hq, hkv, s, d, dtype=torch.float32):
    """q, k, v as [B,H,S,D] views of [B,S,H,D] tensors, as the model passes
    its projections."""
    return [_normal(gen, (b, s, h, d), dtype=dtype).transpose(1, 2)
            for h in (hq, hkv, hkv)]


def lm_shapes() -> dict:
    """granite-3-2b's attention shapes on the LM main path (phase 6d)."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    return {"flash_attention": (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, cfg.hd),
            "flash_decode": (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_MAX_LEN,
                             LM_PROMPT, cfg.hd)}


def phase_attention_parity(shapes: dict) -> dict:
    """flash_attention and flash_decode against their plain versions."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fdec, ref as fdec_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.flash_decode.ref import decode_partials_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}

    def attn(q, k, v, causal, tol, label):
        plain = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal).transpose(1, 2)
        got = fa.flash_attention(q, k, v, causal)
        return kernel_vs_plain(got, plain, tol, label), bar_ratio(got, plain, tol)

    for b, hq, hkv, s, d in [(2, 4, 2, 37, 16), (1, 8, 8, 256, 64), (2, 6, 3, 100, 32)]:
        for causal in (True, False):
            attn(*_attn_inputs(gen, b, hq, hkv, s, d), causal, ATTN_TOL,
                 f"flash_attention {(b, hq, hkv, s, d)} causal={causal}")
    # the tensor-core instance at the widest head dims, ragged S
    for b, hq, hkv, s, d in [(1, 8, 2, 333, 128), (2, 4, 1, 129, 160)]:
        for causal in (True, False):
            attn(*_attn_inputs(gen, b, hq, hkv, s, d, torch.bfloat16), causal, BF16_TOL,
                 f"flash_attention bf16 {(b, hq, hkv, s, d)} causal={causal}")
    b, hq, hkv, s, d = shapes["flash_attention"]
    main_in = _attn_inputs(gen, b, hq, hkv, s, d)
    f32_err, _ = attn(*main_in, True, ATTN_TOL, "flash_attention main path f32")
    main_in = [x.to(torch.bfloat16) for x in main_in]
    errs["flash_attention"], ratio = attn(*main_in, True, ATTN_BF16_TOL,
                                          "flash_attention main path bf16")
    del main_in
    torch.cuda.empty_cache()
    print(f"[parity] flash_attention ok: 3 test shapes x 2 causal settings, f32 at "
          f"{ATTN_TOL:g}; bf16 at D 128 and 160, ragged S, x 2 causal settings, at "
          f"{BF16_TOL:g}; main path B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal: f32 "
          f"max|err|={f32_err:.3g} (bar {ATTN_TOL:g}), bf16 "
          f"max|err|={errs['flash_attention']:.3g} (bar rtol=atol={ATTN_BF16_TOL:g}; "
          f"largest |err| / (atol + rtol |want|) = {ratio:.3f})")

    def partials(got, want, label):
        return max(kernel_vs_plain(x, y, ATTN_TOL, f"{label} {part}")
                   for x, y, part in zip(got, want, ("acc", "m", "l")))

    for bh, g, d, s in [(4, 6, 32, 300), (2, 8, 64, 1024), (1, 1, 16, 50)]:
        q, k, v = (_normal(gen, sh) for sh in ((bh, g, d), (bh, s, d), (bh, s, d)))
        want = decode_partials_plain(q, k[:, :, None], v[:, :, None], s, d ** -0.5)
        partials(fdec.decode_partials(q, k, v), [w[:, 0] for w in want],
                 f"flash_decode {(bh, g, d, s)}")
        kernel_vs_plain(fdec.decode_attention(q, k, v), fdec_ref.decode_attention(q, k, v),
                        ATTN_TOL, f"flash_decode attention {(bh, g, d, s)}")
    q, k, v = (_normal(gen, sh) for sh in ((3, 4, 32), (3, 384, 32), (3, 384, 32)))
    parts = [fdec.decode_partials(q, k[:, lo:hi], v[:, lo:hi])
             for lo, hi in [(0, 128), (128, 256), (256, 384)]]
    kernel_vs_plain(fdec_ref.merge_partials(*zip(*parts)), fdec_ref.decode_attention(q, k, v),
                    ATTN_TOL, "flash_decode shard merge")
    b, hq, hkv, cap, filled, d = shapes["flash_decode"]
    q = _normal(gen, (b, hq, d), dtype=torch.bfloat16)
    kc, vc = (_normal(gen, (b, cap, hkv, d), dtype=torch.bfloat16) for _ in range(2))
    n = torch.tensor(filled, dtype=torch.int32, device="cuda")
    got = fdec.gqa_decode_partials(q, kc, vc, n)
    errs["flash_decode"] = partials(
        got, decode_partials_plain(q, kc, vc, filled, d ** -0.5), "flash_decode main path")
    # repeated calls, and replays of one captured call, give equal results
    # (the merge's per-(b, h) tickets are left at zero by every call)
    outs = [fdec.gqa_decode_partials(q, kc, vc, n) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fdec.gqa_decode_partials(q, kc, vc, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fdec.gqa_decode_partials(q, kc, vc, n)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        outs.append([x.clone() for x in captured])
    for i, out in enumerate(outs):
        for x, y, part in zip(out, got, ("acc", "m", "l")):
            kernel_vs_plain(x, y, 0.0, f"flash_decode repeat {i} {part}")
    print(f"[parity] flash_decode ok: 3 test shapes and the shard merge, f32 at "
          f"{ATTN_TOL:g}; main path B{b} Hq{hq} Hkv{hkv} D{d}, {filled} of {cap} "
          f"slots filled, bf16 cache, max|err|={errs['flash_decode']:.3g} "
          f"(bar {ATTN_TOL:g}); 3 repeated calls and 3 graph replays equal")
    return errs


def _lm_cfg(dtype: str, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), dtype=dtype, **kw)


def _prompt(gen, cfg, b, s):
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")


def phase_lm_f32() -> None:
    """6a-c on granite-3-2b's full width in float32."""
    from repro_torch.core import cost
    from repro_torch.launch.serve_llm_udf import llm_udf_query, naive_and_optimized
    from repro_torch.models import lm
    cfg = _lm_cfg("float32")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = _prompt(gen, cfg, LM_BATCH, LM_PROMPT)
    h = lm.forward(params, cfg, prompt)
    assert h.shape == (LM_BATCH, LM_PROMPT, cfg.d_model) and bool(h.isfinite().all())
    full = h[:, -1].float() @ params["embed"].float().T
    del h
    _, cache = lm.prefill(params, cfg, prompt[:, :-1], max_len=LM_PROMPT)
    dec, cache = lm.make_decode_step(cfg)(params, cache, prompt[:, -1])
    err = float((dec[:, :cfg.vocab] - full[:, :cfg.vocab]).abs().max())
    if not err < CONSISTENCY_TOL or int(cache["len"]) != LM_PROMPT:
        raise AssertionError(f"{LM_ARCH} f32: decode/forward mismatch {err}")
    del cache, dec, full
    print(f"[lm] {LM_ARCH} f32 full width ({cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params): prefill(prompt[:, :-1]) + 1 "
          f"decode step == forward's last logits, B{LM_BATCH} S{LM_PROMPT}, "
          f"max|err|={err:.3g} (bar {CONSISTENCY_TOL:g}; "
          f"{time.perf_counter() - t0:.1f} s)")

    # 6b: the first two layers, card (kernels) against CPU (plain versions)
    two = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": {k: w[:2] for k, w in params["blocks"].items()}}
    two_cpu = {"embed": two["embed"].cpu(), "final_norm": two["final_norm"].cpu(),
               "blocks": {k: w.cpu() for k, w in two["blocks"].items()}}
    cfg2 = _lm_cfg("float32", n_layers=2)
    tok64 = prompt[:1, :64]
    on_card = lm.forward(two, cfg2, tok64).cpu()
    on_cpu = lm.forward(two_cpu, cfg2, tok64.cpu())
    err = kernel_vs_plain(on_card, on_cpu, CARD_CPU_TOL, "card vs cpu")
    print(f"[lm] card vs CPU, 2 layers at full width, f32, one 64-token prompt: "
          f"hidden states max|err|={err:.3g} (bar rtol=atol={CARD_CPU_TOL:g})")
    del two, two_cpu

    # 6c: Appendix K's query with llm_summarize on this model, both plans
    t0 = time.perf_counter()
    plan, catalog, calls = llm_udf_query(params, cfg, device="cuda")
    r = naive_and_optimized(plan, catalog, calls, device="cuda")
    out = r["naive"]
    assert_finite(out, "llm_udf")
    llm = plan.registry.get("llm_summarize")
    rec = plan.registry.get("recommend")
    u = llm.apply(catalog.tables["users"]["user_desc"])
    mv = llm.apply(catalog.tables["movies"]["movie_desc"])
    uid = torch.as_tensor(out["user_id"], dtype=torch.long, device="cuda")
    mid = torch.as_tensor(out["movie_id"], dtype=torch.long, device="cuda")
    want = dict(out, score=rec.apply(u[uid], mv[mid]).cpu().numpy())
    assert_canonical_close(want, out, "llm_udf factorized")
    print(f"[lm] Appendix K query, unoptimized, f32 {LM_ARCH}: {len(out['score'])} "
          f"rows, {r['naive_rows']} LLM rows summarized; scores == factorized evaluation")
    assert_canonical_close(out, r["optimized"], "llm_udf optimized")
    if not r["optimized_rows"] < r["naive_rows"]:
        raise AssertionError(f"[lm] Appendix K optimized: {r['optimized_rows']} LLM rows, "
                             f"not fewer than the naive plan's {r['naive_rows']}")
    print(f"[lm] Appendix K optimized (vanilla MCTS, 40 iterations, seed 0, "
          f"{cost.catalog_profile(catalog).name} prior; estimated speedup "
          f"{r['stats']['speedup']:.3f}x): LLM rows summarized naive {r['naive_rows']}, "
          f"optimized {r['optimized_rows']} "
          f"({r['naive_rows'] / max(r['optimized_rows'], 1):.1f}x fewer); results == "
          f"the unoptimized plan's at 5e-4 ({time.perf_counter() - t0:.1f} s)")
    del params


def _clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def _cut_layers(params: dict, n: int, device=None) -> dict:
    """The first ``n`` layers of every stacked block group, on ``device``
    (by default where they are)."""
    return {k: ({kk: w[:n].to(device or w.device) for kk, w in v.items()}
                if isinstance(v, dict) else v.to(device or v.device))
            for k, v in params.items()}


def card_vs_cpu(label: str, cfg, params: dict, n_layers: int, tokens, **kw) -> float:
    """``forward`` of the first layers of ``params`` (float32, full width)
    on the card (the kernels) and on the CPU (the plain versions)."""
    import dataclasses
    from repro_torch.models import lm
    cut = dataclasses.replace(cfg, n_layers=n_layers,
                              enc_layers=n_layers if cfg.enc_layers else 0)
    two = _cut_layers(params, n_layers)
    on_card = lm.forward(two, cut, tokens, **kw).cpu()
    two_cpu = _cut_layers(params, n_layers, "cpu")
    on_cpu = lm.forward(two_cpu, cut, tokens.cpu(),
                        **{k: v.cpu() for k, v in kw.items()})
    err = kernel_vs_plain(on_card, on_cpu, CARD_CPU_TOL, f"{label} card vs cpu")
    print(f"[{label}] card vs CPU, {n_layers}{'+' + str(n_layers) if cfg.enc_layers else ''} "
          f"layers at full width, f32, B{tokens.shape[0]} x {tokens.shape[1]} tokens: "
          f"hidden states max|err|={err:.3g} (bar rtol=atol={CARD_CPU_TOL:g})")
    return err


def decode_eager_vs_captured(label: str, cfg, params: dict, cache: dict, tok0):
    """``LM_STEPS`` greedy steps from ``cache`` twice: eagerly
    (``make_decode_step``) and through a ``Server``'s captured step (one
    CUDA-graph replay a step). The tokens must be equal and the logits
    within the bf16 bar. Returns the server and the largest |err|."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    step = lm.make_decode_step(cfg)
    eager, c, tok = [], _clone(cache), tok0
    for _ in range(LM_STEPS):
        logits, c = step(params, c, tok)
        tok = logits.argmax(-1)
        eager.append((tok, logits))
    del c
    server = serve.Server(cfg, batch=tok0.shape[0], max_len=cache["k"].shape[2],
                          device="cuda", params=params)
    server.cache = _clone(cache)
    tok, err = tok0, 0.0
    for i, (want_tok, want) in enumerate(eager):
        tok = server.decode(tok)
        if not torch.equal(tok.long(), want_tok):
            raise AssertionError(f"{label}: captured step {i} tokens {tok.tolist()} != "
                                 f"eager {want_tok.tolist()}")
        err = max(err, kernel_vs_plain(server.logits[:, :cfg.vocab], want[:, :cfg.vocab],
                                       BF16_TOL, f"{label} captured logits, step {i}"))
    if server.captures != 1:
        raise AssertionError(f"{label}: {server.captures} captures, want 1")
    return server, err


def time_decode(label: str, cfg, params: dict, cache: dict, tok0, server, err: float,
                also: tuple = ()) -> tuple:
    """Each path's ms per step: medians of ``TIMED_RUNS`` runs of
    ``LM_STEPS`` steps from ``cache``'s length after a warm-up (CUDA events,
    tokens fed back on the card); the capture's seconds and pool; one
    profiled replay. Returns (eager, captured) ms per step."""
    from repro_torch.models import lm
    step = lm.make_decode_step(cfg)
    b, start = tok0.shape[0], int(cache["len"])
    len0 = torch.tensor(start, dtype=torch.int32, device="cuda")

    def run_eager():
        c, t = dict(cache, len=len0), tok0
        for _ in range(LM_STEPS):
            logits, c = step(params, c, t)
            t = logits.argmax(-1)

    def run_graph():
        server.cache["len"].fill_(start)
        t = tok0
        for _ in range(LM_STEPS):
            t = server.decode(t)

    eager_ms = median_run_ms(run_eager) / LM_STEPS
    graph_ms = median_run_ms(run_graph) / LM_STEPS
    cap = server.captured
    print(f"[decode-graph] {label} bf16 B{b} from {start} filled slots: {LM_STEPS} "
          f"captured steps' tokens == eager's, logits max|err|={err:.3g} (bar "
          f"{BF16_TOL:g}); eager {eager_ms:.3f} ms/step ({b / eager_ms * 1e3:.1f} tok/s), "
          f"captured {graph_ms:.3f} ms/step ({b / graph_ms * 1e3:.1f} tok/s), "
          f"{eager_ms / graph_ms:.2f}x; medians of {TIMED_RUNS}; {server.captures} "
          f"capture: warm-up {cap.warmup_s:.3f} s, capture {cap.capture_s:.3f} s, pool "
          f"{cap.pool_bytes / 2**20:.1f} MiB")
    server.cache["len"].fill_(start)
    profile_breakdown(f"{label} captured decode step, one replay",
                      lambda: server.decode(tok0), also=also)
    return eager_ms, graph_ms


def check_launches(label: str, launches: dict, want: dict) -> None:
    print(f"[main] {label} kernels " + json.dumps(launches))
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{label} main path launches {launches}, want {want}")


def phase_lm_bf16() -> tuple:
    """6d-e on granite-3-2b in bfloat16; returns the LM main path's launch
    counts and its cache (for the kernel times)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = _lm_cfg("bfloat16")
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = _prompt(gen, cfg, LM_BATCH, LM_PROMPT)
    step = lm.make_decode_step(cfg)

    def generate(cache, tok):
        for _ in range(LM_STEPS):
            logits, cache = step(params, cache, tok)
            tok = logits.argmax(-1)
        return logits, cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, cache = lm.prefill(params, cfg, prompt, max_len=LM_MAX_LEN)
    tok0 = logits.argmax(-1)
    last, _ = generate(cache, tok0)
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches("lm", launches, {"flash_attention": cfg.n_layers,
                                    "flash_decode": cfg.n_layers * LM_STEPS})
    assert bool(logits.isfinite().all()) and bool(last[:, :cfg.vocab].isfinite().all())

    prefill_ms = median_run_ms(lambda: lm.prefill(params, cfg, prompt, LM_MAX_LEN))
    print(f"[lm] {LM_ARCH} bf16 full width, B{LM_BATCH}: prefill {LM_PROMPT} tokens "
          f"{prefill_ms:.3f} ms ({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} tok/s), "
          f"median of {TIMED_RUNS}; peak memory {peak_gb:.2f} GB (prefill and "
          f"{LM_STEPS} eager steps)")
    profile_breakdown(f"{LM_ARCH} prefill B{LM_BATCH}xS{LM_PROMPT}",
                      lambda: lm.prefill(params, cfg, prompt, LM_MAX_LEN), top=8)
    len0 = torch.tensor(LM_PROMPT, dtype=torch.int32, device="cuda")
    profile_breakdown(f"{LM_ARCH} eager decode step B{LM_BATCH} at {LM_PROMPT} slots",
                      lambda: step(params, dict(cache, len=len0), tok0), also=("fdk::",))
    # [decode-graph]: the server's captured step against the eager one
    server, err = decode_eager_vs_captured(LM_ARCH, cfg, params, cache, tok0)
    time_decode(LM_ARCH, cfg, params, cache, tok0, server, err, also=("fdk::",))
    del server

    server = serve.Server(cfg, batch=LM_BATCH, max_len=256, device="cuda", params=params)
    eager = serve.Server(cfg, batch=LM_BATCH, max_len=256, device="cuda", params=params)
    # the same server with its step called eagerly: a yardstick of this
    # run, not an option of the server
    eager.decode = lambda t: eager._step_body(torch.as_tensor(t, dtype=torch.int32)
                                              .to("cuda"))[0]
    rates = {}
    for name, srv in (("captured", server), ("eager", eager)):
        requests = serve.synthetic_requests(cfg, 8, 16)
        t0 = time.perf_counter()
        steps = serve.serve(srv, requests)
        dt = time.perf_counter() - t0
        bad = [r.rid for r in requests
               if not r.done or len(r.out) != len(r.prompt) + r.max_new
               or not all(0 <= t < cfg.vocab for t in r.out)]
        if bad:
            raise AssertionError(f"server ({name}): requests {bad} not served right")
        rates[name] = (len(requests) * 16 / dt, dt, steps, [r.out for r in requests])
    if rates["captured"][3] != rates["eager"][3]:
        raise AssertionError("server: captured and eager steps served other tokens")
    # a functional check of the server: 8 short requests are no measurement
    # of serving, so their rate is printed but not kept as a metric
    print(f"[serve] {LM_ARCH} bf16: 8 requests, {rates['captured'][2]} decode steps, "
          f"captured step {rates['captured'][0]:.1f} tok/s ({rates['captured'][1]:.2f} s, "
          f"{server.captures} capture) against the same server stepping eagerly "
          f"{rates['eager'][0]:.1f} tok/s ({rates['eager'][1]:.2f} s); the same tokens "
          f"(batch {LM_BATCH}, max_len 256; functional run, not a serving benchmark)")
    del server, eager, params
    return launches, cache


FAMILY_BATCH, FAMILY_PROMPT, FAMILY_MAX_LEN = 4, 2048, 4096
MROPE_LAYERS = 16  # qwen2-vl-72b: 16 of 80 layers (about 31 GB of bf16 weights)


def _family_cfg(arch: str, dtype: str = "bfloat16", **kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype=dtype, **kw)


def _free(*_) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def family_main_path(label: str, cfg, params: dict, prompt, also: tuple = (),
                     n_attn: int = 1, **kw) -> dict:
    """A family's LM main path in bfloat16: prefill ``prompt`` (max_len
    ``FAMILY_MAX_LEN``), then ``decode_eager_vs_captured``; launch counts
    zeroed just before and read just after (prefill's flash_attention calls,
    and per decode step ``n_attn`` flash_decode calls a layer: the eager
    steps' and the capture's warm-up and capture, never a replay)."""
    from repro_torch.models import lm
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, cache = lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN, **kw)
    tok0 = logits.argmax(-1)
    server, err = decode_eager_vs_captured(label, cfg, params, cache, tok0)
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    encdec = cfg.kind == "encdec"  # prefill: encoder, self- and cross-attention
    check_launches(label, launches, {
        "flash_attention": cfg.n_layers + (cfg.enc_layers + cfg.n_layers) * encdec,
        "flash_decode": n_attn * cfg.n_layers * (LM_STEPS + 2)})
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"{label}: prefill logits not finite")
    time_decode(label, cfg, params, cache, tok0, server, err, also=also)
    del server, cache
    prefill_ms = median_run_ms(lambda: lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN, **kw))
    b, s = prompt.shape
    print(f"[{label}] bf16 prefill B{b} x {s} tokens {prefill_ms:.3f} ms "
          f"({b * s / prefill_ms * 1e3:.0f} tok/s), median of {TIMED_RUNS}; peak memory "
          f"{peak_gb:.2f} GB (prefill, {LM_STEPS} eager and {LM_STEPS} captured steps)")
    return launches


def phase_lm_moe() -> None:
    """[lm-moe]: granite-moe-1b-a400m at full width and depth (24 layers,
    d 1024, 16/8 heads, 32 experts top-8, d_expert 512)."""
    from repro_torch.models import layers as L, lm
    arch = "granite-moe-1b-a400m"
    cfg32 = _family_cfg(arch, "float32")
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 2, 64)  # 128 tokens: every assignment kept
    h = lm.forward(params, cfg32, prompt)
    full = h[:, -1].float() @ params["embed"].float().T
    _, cache = lm.prefill(params, cfg32, prompt[:, :-1], max_len=64)
    dec, cache = lm.make_decode_step(cfg32)(params, cache, prompt[:, -1])
    err = float((dec[:, :cfg32.vocab] - full[:, :cfg32.vocab]).abs().max())
    if not err < CONSISTENCY_TOL:
        raise AssertionError(f"{arch} f32: decode/forward mismatch {err}")
    print(f"[lm-moe] {arch} f32 full width and depth ({cfg32.n_layers} layers, "
          f"{cfg32.param_count() / 1e9:.2f} B params): prefill(prompt[:, :-1]) + 1 decode "
          f"step == forward's last logits, B2 x 64 (t <= {L.DROPLESS_TOKENS}, dropless), "
          f"max|err|={err:.3g} (bar {CONSISTENCY_TOL:g})")
    card_vs_cpu("lm-moe", cfg32, params, 2, prompt)
    del params, h, full, cache, dec
    _free()

    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    t = FAMILY_BATCH * FAMILY_PROMPT
    counts, route = [], L.route
    with counting(L, "route", counts, key=lambda x, rw, k: torch.bincount(
            route(x, rw, k)[1].flatten(), minlength=cfg.moe.n_experts)):
        lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN)
    cap = L.capacity(cfg, t)
    dropped = sum(int(torch.clamp(c - cap, min=0).sum()) for c in counts)
    print(f"[lm-moe] bf16 prefill of B{FAMILY_BATCH} x {FAMILY_PROMPT} = {t} tokens: "
          f"capacity {cap} slots an expert; {dropped} of {len(counts) * t * cfg.moe.top_k} "
          f"routed assignments dropped over {len(counts)} layers "
          f"({100 * dropped / (len(counts) * t * cfg.moe.top_k):.3f}%)")
    family_main_path("lm-moe", cfg, params, prompt, also=("fdk::",))
    del params
    _free()


def phase_lm_mrope() -> None:
    """[lm-mrope]: qwen2-vl-72b at full width (d 8192, 64/8 heads, head dim
    128, d_ff 29,568, vocab 152,064), depth cut to 16 of 80 layers."""
    from repro_torch.models import lm
    arch = "qwen2-vl-72b"
    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg32 = _family_cfg(arch, "float32", n_layers=2)
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 1, 64)
    pos3 = torch.randint(0, 64, (3, 1, 64), generator=gen, device="cuda")
    card_vs_cpu("lm-mrope", cfg32, params, 2, prompt, pos3=pos3)
    del params
    _free()

    cfg = _family_cfg(arch, n_layers=MROPE_LAYERS)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    # M-RoPE ids from a seed: time along the prompt, height and width on a grid
    grid = torch.randint(0, 48, (2, FAMILY_BATCH, FAMILY_PROMPT), generator=gen,
                         device="cuda")
    pos3 = torch.cat([torch.arange(FAMILY_PROMPT, device="cuda").expand(
        1, FAMILY_BATCH, FAMILY_PROMPT), grid])
    print(f"[lm-mrope] {arch} bf16 full width, {MROPE_LAYERS} of 80 layers "
          f"({cfg.param_count() / 1e9:.2f} B params), "
          f"pos3 = (t: 0..{FAMILY_PROMPT - 1}, h and w: seeded in 0..47)")
    family_main_path("lm-mrope", cfg, params, prompt, also=("fdk::",), pos3=pos3)
    del params
    _free()


def phase_lm_encdec() -> None:
    """[lm-encdec]: seamless-m4t-medium at full width and depth (12 encoder
    and 12 decoder layers, d 1024, 16/16 heads, d_ff 4096, gelu, vocab
    256,206); the encoder reads B 4 x 2048 frames from a seed (the stubbed
    audio frontend's output)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    arch = "seamless-m4t-medium"
    gen = torch.Generator(device="cuda").manual_seed(8)
    cfg32 = _family_cfg(arch, "float32", n_layers=2, enc_layers=2)
    params = lm.init_params(cfg32, seed=0, device="cuda")
    frames = torch.randn((1, 64, cfg32.d_model), generator=gen, device="cuda")
    card_vs_cpu("lm-encdec", cfg32, params, 2, _prompt(gen, cfg32, 1, 64),
                enc_embeds=frames)
    del params
    _free()

    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    frames = torch.randn((FAMILY_BATCH, FAMILY_PROMPT, cfg.d_model), generator=gen,
                         device="cuda")
    family_main_path("lm-encdec", cfg, params, prompt, n_attn=2, enc_embeds=frames)
    # the server as the reference runs it: an empty encoder memory
    server = serve.Server(cfg, batch=FAMILY_BATCH, max_len=256, device="cuda",
                          params=params)
    requests = serve.synthetic_requests(cfg, 8, 16)
    steps = serve.serve(server, requests)
    if not (bool(server.logits[:, :cfg.vocab].isfinite().all())
            and all(r.done and all(0 <= t < cfg.vocab for t in r.out) for r in requests)):
        raise AssertionError("lm-encdec: the server over an empty memory gave non-finite "
                             "logits or tokens out of range")
    print(f"[lm-encdec] server over an empty encoder memory (enc_h "
          f"{tuple(server.cache['enc_h'].shape)}): 8 requests, {steps} captured steps "
          f"({server.captures} capture), finite logits")
    del server, params
    _free()


def phase_family_attention() -> None:
    """[parity] both attention kernels at the new families' shapes against
    their plain versions, each at its existing bar, with the kernel's time
    beside one SDPA call's."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.flash_decode import ops as fdec
    from repro_torch.kernels.flash_decode.ref import decode_partials_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s = FAMILY_BATCH, FAMILY_PROMPT
    form, (_, bytes_peak, bf16_peak, _) = card_peaks(torch.cuda.get_device_name(0))

    def bound(flops, nbytes):  # as phase 7's rows: the larger of the two times
        t_ops, t_bytes = flops / bf16_peak * 1e3, nbytes / bytes_peak * 1e3
        return (f"bound {max(t_ops, t_bytes):.4f} ms by "
                f"{'operations' if t_ops >= t_bytes else 'bytes'} ({form} peaks)")
    for label, hq, hkv, skv, d, causal in (
            ("qwen2-vl prefill", 64, 8, s, 128, True),
            ("granite-moe prefill", 16, 8, s, 64, True),
            ("seamless decoder self", 16, 16, s, 64, True),
            ("seamless encoder / cross", 16, 16, s, 64, False),
            ("seamless cross, Skv != Sq", 16, 16, 1000, 64, False)):
        q = _normal(gen, (b, s, hq, d), dtype=torch.bfloat16).transpose(1, 2)
        k, v = (_normal(gen, (b, skv, hkv, d), dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, causal)
        want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal=causal).transpose(1, 2)
        err = kernel_vs_plain(got, want, ATTN_BF16_TOL, f"flash_attention {label}")
        del want
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                              enable_gqa=True))
        pairs = s * (s + 1) // 2 if causal else s * skv  # (row, col) pairs a head
        print(f"[parity] flash_attention {label}: B{b} Hq{hq} Hkv{hkv} Sq{s} Skv{skv} "
              f"D{d} {'causal' if causal else 'non-causal'} bf16, max|err|={err:.3g} "
              f"(bar rtol=atol={ATTN_BF16_TOL:g}); kernel {ms:.4f} ms, SDPA {sdpa:.4f} ms, "
              + bound(4.0 * b * hq * d * pairs, 2.0 * b * d * (2 * s * hq + 2 * skv * hkv)))
        del q, k, v, got
    _free()
    for label, hq, hkv, cap, filled, d in (
            ("qwen2-vl, G 8", 64, 8, FAMILY_MAX_LEN, s, 128),
            ("granite-moe, G 2", 16, 8, FAMILY_MAX_LEN, s, 64),
            ("seamless self, G 1", 16, 16, FAMILY_MAX_LEN, s, 64),
            ("seamless cross, G 1", 16, 16, s, s, 64)):
        q = _normal(gen, (b, hq, d), dtype=torch.bfloat16)
        kc, vc = (_normal(gen, (b, cap, hkv, d), dtype=torch.bfloat16) for _ in range(2))
        n = torch.tensor(filled, dtype=torch.int32, device="cuda")
        got = fdec.gqa_decode_partials(q, kc, vc, n)
        want = decode_partials_plain(q, kc, vc, filled, d ** -0.5)
        err = max(kernel_vs_plain(x, y, ATTN_TOL, f"flash_decode {label} {part}")
                  for x, y, part in zip(got, want, ("acc", "m", "l")))
        ms = graph_ms(lambda: fdec.gqa_decode_partials(q, kc, vc, n))
        q1 = q.view(b, hq, 1, d)
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            q1, kc[:, :filled].transpose(1, 2), vc[:, :filled].transpose(1, 2),
            enable_gqa=True))
        print(f"[parity] flash_decode {label}: B{b} Hq{hq} Hkv{hkv} D{d}, {filled} of "
              f"{cap} slots, bf16, max|err|={err:.3g} (bar {ATTN_TOL:g}); kernel "
              f"{ms:.4f} ms, SDPA {sdpa:.4f} ms (graph replays), " + bound(
                  4.0 * b * hq * d * filled,
                  2.0 * (b * hq * d + 2 * b * filled * hkv * d) + 4.0 * (b * hq * d + 2 * b * hq)))
        del q, kc, vc
    _free()


def phase_attention_times(shapes: dict, launches: dict, errs: dict, card: str,
                          cache: dict) -> list:
    """Both attention kernels at the LM main path's shapes. Decode runs over
    the 40 layers of the main path's own cache in turn, so each call finds
    its layer cold in L2, as in a decode step; its calls are shorter than
    their host overhead, so they are timed from a CUDA graph replay."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fdec
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.flash_decode.ref import decode_partials_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    b, hq, hkv, s, d = shapes["flash_attention"]
    q, k, v = _attn_inputs(gen, b, hq, hkv, s, d, torch.bfloat16)
    pairs = s * (s + 1) // 2  # causal (row, col) pairs per head
    rows.append(kernel_row(
        "flash_attention", lambda: fa.flash_attention(q, k, v, True),
        lambda: flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        4.0 * b * hq * d * pairs, 2.0 * b * s * d * (2 * hq + 2 * hkv),
        (b, hq, hkv, s, d, "causal bf16"), launches, errs, card, bf16=True))
    del q, k, v
    torch.cuda.empty_cache()
    b, hq, hkv, cap, filled, d = shapes["flash_decode"]
    n_layers = cache["k"].shape[0]
    q = _normal(gen, (b, hq, d), dtype=torch.bfloat16)
    n = torch.tensor(filled, dtype=torch.int32, device="cuda")
    ks, vs = cache["k"], cache["v"]
    q1 = q.view(b, hq, 1, d)
    rows.append(kernel_row(
        "flash_decode",
        lambda: [fdec.gqa_decode_partials(q, ks[i], vs[i], n) for i in range(n_layers)],
        lambda: [decode_partials_plain(q, ks[i], vs[i], n, d ** -0.5)
                 for i in range(n_layers)],
        lambda: [F.scaled_dot_product_attention(
            q1, ks[i, :, :filled].transpose(1, 2), vs[i, :, :filled].transpose(1, 2),
            enable_gqa=True) for i in range(n_layers)],
        4.0 * b * hq * d * filled,
        2.0 * (b * hq * d + 2 * b * filled * hkv * d) + 4.0 * (b * hq * d + 2 * b * hq),
        (b, hq, hkv, f"{filled}/{cap} slots", d, "bf16"), launches, errs, card,
        bf16=True, per_call=n_layers, graph=True))
    return rows


def kernel_row(name, kernel, plain, library, flops, nbytes, shape, launches,
               errs, card, bf16=False, per_call=1, graph=False,
               split_flops=None, note=None) -> dict:
    """One kernel's JSON row: its time, its plain version's and one library
    call's (mean ms of one call; ``per_call`` calls per timed lambda, timed
    from a CUDA graph replay if ``graph``), and the bound from the
    operations and bytes of one call. ``split_flops`` (2MNK of an f32 GEMM
    on the tensor cores) makes the operations bound 3 x split_flops at the
    TF32 rate, f32-accurate work by the three-way split; the CUDA-core f32
    bound of ``flops`` is printed beside it. ``note(kernel_ms)`` adds text to
    the printed line."""
    form, (f32_peak, bytes_peak, bf16_peak, tf32_peak) = card_peaks(card)
    if split_flops:
        t_ops, unit = 3 * split_flops / tf32_peak * 1e3, "3xTF32 tensor"
        flops_peak = tf32_peak
    else:
        flops_peak, unit = (bf16_peak, "bf16 tensor") if bf16 else (f32_peak, "f32")
        t_ops = flops / flops_peak * 1e3
    t_bytes = nbytes / bytes_peak * 1e3
    timer = graph_ms if graph else cuda_ms
    row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
           "replaces": KERNELS[name][1], "launches": launches[name],
           "max_abs_err": errs[name], "ms": timer(kernel) / per_call,
           "plain_ms": timer(plain) / per_call, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": timer(library) / per_call if library else None}
    lib_ms = f"{row['library_ms']:.4f} ms" if library else "none"
    rate = (f"{flops / row['ms'] / 1e9:.1f} TFLOP/s" if row["bound_by"] == "operations"
            else f"{nbytes / row['ms'] / 1e6:.1f} GB/s")
    # with graph timing, also the same calls eager, host overhead included
    eager = (f"; eager, host overhead included: kernel {cuda_ms(kernel) / per_call:.4f}"
             f" ms, library {cuda_ms(library) / per_call:.4f} ms" if graph else "")
    simt = (f"; CUDA-core f32 bound {max(flops / f32_peak * 1e3, t_bytes):.4f} ms "
            f"({f32_peak / 1e12:g} TFLOP/s)" if split_flops else "")
    print(f"[time] {name} {shape}{' (graph replay)' if graph else ''}: "
          f"kernel {row['ms']:.4f} ms ({rate}, {100 * row['bound_ms'] / row['ms']:.1f}% "
          f"of the bound), plain "
          f"{row['plain_ms']:.4f} ms, library {lib_ms}, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}"
          f"{', ' + unit if row['bound_by'] == 'operations' else ''} "
          f"({form} peaks: {flops_peak / 1e12:g} TFLOP/s {unit}, "
          f"{bytes_peak / 1e12:g} TB/s){simt}{eager}{note(row['ms']) if note else ''}")
    return row


def phase_kernel_times(shapes: dict, launches: dict, errs: dict,
                       card: str) -> list:
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    m, k, n, t = shapes["block_matmul"]
    x, w = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5)
    rows.append(kernel_row(
        "block_matmul", lambda: bm.block_matmul(x, w, t),
        lambda: bm_ref.block_matmul(x, w, t), lambda: torch.matmul(x, w),
        2.0 * m * n * k, 4.0 * (m * k + k * n + m * n), (m, k, n, t),
        launches, errs, card, split_flops=2.0 * m * n * k))
    del x, w
    m, k, n, act = shapes["fused_dense"]
    x, w, b = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5), _normal(gen, (n,))
    # library yardstick: one addmm, i.e. bias + product without the activation
    rows.append(kernel_row(
        "fused_dense", lambda: fd.fused_dense(x, w, b, act),
        lambda: fd_ref.fused_dense(x, w, b, act), lambda: torch.addmm(b, x, w),
        2.0 * m * n * k + 2.0 * m * n, 4.0 * (m * k + k * n + n + m * n),
        (m, k, n, act), launches, errs, card, split_flops=2.0 * m * n * k))
    del x, w, b
    torch.cuda.empty_cache()
    n, d, t, depth = shapes["decision_forest"]
    args = _forest_inputs(gen, n, d, t, depth)
    nn = 2 ** depth - 1
    # beside the roofline: the design's floor, its shared-memory requests
    # (n*T*D lookups, 32 a warp step at 3 wavefronts) at one wavefront per
    # SM per clock, at the SM clock nvidia-smi reads as its maximum
    n_sm = _n_sm()
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    floor_ms = df.request_floor_ms(n, t, depth, n_sm, max_mhz * 1e6)
    rows.append(kernel_row(
        "decision_forest", lambda: df.forest_predict(*args),
        lambda: df_ref.forest_predict(*args), None,
        float(n) * t * (depth + 1),
        4.0 * (n * d + t * (2 * nn + 2 ** depth) + n), (n, d, t, depth),
        launches, errs, card,
        note=lambda ms: (
            f"; design floor (shared-memory requests: {n}x{t}x{depth} lookups, "
            f"{df.WAVEFRONTS_PER_STEP} wavefronts a warp step, {n_sm} SMs at "
            f"{max_mhz:g} MHz) {floor_ms:.4f} ms, {100 * floor_ms / ms:.1f}% of it; "
            f"SM clock after the timing {_smi('clocks.sm')}; tiling "
            f"{df.forest_tiling(n, d, t, depth, n_sm)}")))
    return rows


def main() -> int:
    card = phase_device()
    phase_build()
    phase_parity()
    errs = phase_attention_parity(lm_shapes())
    launches, refs = phase_main_path()
    profile = phase_lower()
    phase_plan(profile, refs)
    shapes = phase_full_size(profile)
    errs.update(phase_main_shape_parity(shapes))
    phase_embed()
    phase_reusable(profile, phase_train(profile))
    phase_cache()
    server, cache = phase_serving()
    phase_feedback(server, cache)
    del server, cache
    torch.cuda.empty_cache()
    phase_lm_f32()
    torch.cuda.empty_cache()
    lm_launches, cache = phase_lm_bf16()
    rows = phase_kernel_times(shapes, launches, errs, card)
    rows += phase_attention_times(lm_shapes(), lm_launches, errs, card, cache)
    del cache
    _free()
    phase_family_attention()
    phase_lm_moe()
    phase_lm_mrope()
    phase_lm_encdec()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
