#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and cuDNN.
2. build: compiles the six CUDA kernel libraries (the five ported kernels
   and flash_attention's backward) from src/repro_torch/kernels/csrc,
   one nvcc per source, all started together; prints ptxas's registers,
   shared memory and spills per decision_forest instance and per kernel of
   flash_attention's backward (and fails on a spill in either); checks in
   their SASS (cuobjdump) that every instance of the two GEMMs
   (block_matmul and fused_dense: f32 and bf16, 16-byte and element
   copies) and the bf16 attention instances, the backward's included, run
   on tensor cores.
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
5f. [mesh]: the multi-device engine on the one card. A 1-wide mesh over an
   NCCL group of one rank: ``get_or_compile_partitioned`` is the plain
   entry and nothing shards. Then 4 gloo ranks spawned onto cuda:0 (NCCL
   refuses two ranks on one GPU; gloo takes CUDA tensors), each running
   ``mesh_rank``: the 12 workloads at scale 1.0 row- and hash-partitioned,
   through ``kernel_plan`` and through costed lowering's decisions, each
   against the rank's single-device run (masks and ints exact, floats
   2e-5), then analytics_q1@100 and rec_q3@20 (kernel plans) through
   ``QueryServer(mesh=, memory_budget=)`` under an artificial budget
   (``repro_torch.testing.partition_budget``), each served by the
   partitioned executable, against ``execute``; launch counts zeroed just before
   each partitioned run and read just after. Per rank: launches (block_matmul
   and decision_forest must be non-zero) and the kernels' shapes, row blocks
   and their tail padding marked; each engine kernel at its largest
   tail-padded row block against its plain version; the seconds and each
   rank's peak memory: ranks time-slicing one card, no multi-card speed.
5g. [lm-mesh]: the LM on a (data, model) mesh of the same 4 gloo ranks on
   cuda:0. Each config runs first on one rank in this process (prefill
   B 4 x 2048, max_len 4096, 2 decode steps on seeded tokens, and one step
   from an empty cache; its logits saved, the rest freed): granite-3-2b
   (bf16, 40 layers, on a 1x4 and a 2x2 mesh), stablelm-12b (bf16,
   12 of 40 layers, tensor parallel), granite-moe-1b-a400m (bf16, 12 of
   24 layers, 32 experts over 4 ranks), deepseek-v2-236b at full width (160 experts over 4 ranks,
   the latent cache S-sharded; f32 at 2 and bf16 at 6 of its 60 layers)
   and zamba2-1.2b (f32 and bf16), xlstm-1.3b (f32 at 2, f64 at 8 and
   bf16 at 16 of its 48 layers, a 512-token prompt; one mLSTM head a
   rank) and
   seamless-m4t-medium (f32 and bf16, 12 + 12 layers over 2,048 frames; 4
   of 16 heads a rank), all 1x4 but the 2x2; granite-3-2b at 4
   layers in f32 on a 2x1x2 (pod, data, model) mesh, its batch rows over
   pod and data. Every rank makes
   its own params (``init_params(mesh=)``, one rank at a time), steps once
   from an empty cache (every slice but the first rank's empty), prefills
   with ``prefill(mesh=)`` and decodes 2 steps through ``Server(mesh=)``
   (eager); its logits against the one rank's at ``lm_mesh_bar`` (2e-4 in
   f32, 3e-2 in bf16, 1e-6 in f64; in bf16 and in f32 for ``F32_ULP_ARCHS``, 4x
   the one-rank run's response to a one-ulp move of the embeddings, if
   larger; the rows past 2e-4 or 3e-2 are printed);
   the flash_decode kernel on its own slice of the cache against its plain
   version (2e-4; an empty slice: m -1e30, finite acc and l; seamless's
   cross-attention too, at its rows and heads), and flash_attention at
   the (q, k, v, causal) each rank's prefill gave it (its rows and heads:
   MLA 32 of 128 heads at (192, 128), zamba2 8 of 32, seamless 4 of 16).
   Launches are zeroed just before the prefill, the steps and the empty
   step and read just after each (``mesh_launches``): flash_attention once
   an attention layer in the prefill, flash_decode once an attention layer
   a step on every rank (none for MLA and xLSTM; the encoder-decoder's
   empty encoder memory none). Per rank: launches, errors, seconds, ms per eager step,
   peak memory, all of ranks time-slicing one card.
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
9. the LM path's last single-device families, each freed before the next:
   a. [parity]: flash_attention at MLA's (D, Dv) pairs, deepseek-v2's
      prefill (B 4, S 2048, 128 heads, Dqk 192, Dv 128, causal) and the
      narrow (64, 32) pair at the same shape, f32 (2e-4) and bf16 (1e-2)
      against the plain version; the bf16 time beside SDPA's (and each
      SDPA backend's, where it takes Dv != Dqk) and the bound;
   b. [lm-mla] deepseek-v2-236b at full width, 6 of 60 layers: in f32 one
      full-width layer with 16 of its 160 experts, decode == forward (1e-2)
      and card vs CPU (1e-4); in bf16 the drop share of a B 4 x 2048
      prefill, then the family's main path (6 flash_attention launches a
      prefill; MLA decode attends in its latent space, no kernel);
   c. [lm-hybrid] zamba2-1.2b, nothing cut: f32 decode == forward, 2 layers
      and the shared block card vs CPU; the main path (7 flash_attention a
      prefill, 7 flash_decode a decode step);
   d. [lm-xlstm] xlstm-1.3b, nothing cut: decode == forward at 8 (one
      segment: 7 mLSTM + 1 sLSTM layers), 16 and 48 layers, in float64
      (1e-6) and in f32 (1e-2); deeper, where random weights amplify any
      rounding, at most 4x forward's change for a one-ulp move of the
      embeddings, if that is larger;
      1 mLSTM + 1 sLSTM layer card vs CPU; the main path, which launches no
      kernel (prefill's sLSTM scans its 2,048 tokens eagerly).
10. LM training (``lm.loss_fn``, ``lm.make_train_step``, ``train.*``):
   a. [parity] flash_attention backward (after phase 3): the kernels of
      csrc/flash_attention_bwd.cu against ``flash_attention_bwd_plain`` on
      the plain forward's o and lse, every instantiated (D, Dv) pair at
      three test shapes (G 1/2/4, ragged S and Skv), causal and not, f32
      at 2e-4 and bf16 at 3e-2; then bf16 at granite-3-2b's training shape
      (B 4, S 2048, 32 / 8 heads, D 64, causal), MLA's (192, 128) at B 1
      with 128 heads and seamless's non-causal cross attention at Skv
      1000; two calls bit-equal; the forward with lse bit-equal to the
      forward without it, its lse against the plain version's;
   b. [lm-train]: one train step's loss and gradients in f32 on the card
      (the kernels, forward and backward) against the CPU (the plain
      versions): granite-3-2b at full width cut to 2 layers, B 2 x 128,
      deepseek-v2's smoke config at the kernel's (64, 32) pair and
      zamba2's smoke config, B 2 x 64; the loss at 1e-4, every gradient
      leaf at 2e-4 of its largest |g|, and one ``make_train_step`` each
      whose losses agree at 1e-4. Then granite-3-2b at full width and
      depth in bf16 (remat on, as its config says), AdamW with f32
      moments, ``TokenPipeline`` batches of B 4 x 2048 in 2 microbatches,
      8 steps: the losses (finite), ms a step, tokens/s, peak memory and
      the launches a step (flash_attention's forward 160, twice a layer
      and microbatch under remat; its backward 80), then one profiled
      step. On the smoke config (bf16): the loss falls over 12 steps
      (``tests/test_train_infra.py``'s run) and 3 steps + checkpoint +
      restore + 3 steps equal 6 straight steps (rtol 1e-5). [dryrun] on the
      full-depth model: one more step under ``launch.trace_cost``'s counter
      on the card, whose FLOPs must equal the same step traced on meta
      tensors as launch analysis traces it (``lm.abstract_params``), the
      predicted argument bytes equal to the distinct storages that the
      card's allocator holds for the same state; the meta trace's
      predicted peak against the phase's measured peak (a ratio), its
      compute term at the bf16 peak against the measured step;
   [dryrun] ``torch.library.opcheck`` of every kernel operator at its
      main-path shape (schema, autograd registration, the shape-only
      implementation's shapes, dtypes and strides against the kernel's);
   c. [time] flash_attention backward at the training shapes of
      granite-3-2b (the JSON row), qwen2-vl (D 128, 64 / 8 heads), MLA
      ((192, 128), B 1 x 128 heads) and seamless's cross attention (non-
      causal, Skv 1000): the kernels' ms beside the plain version's and
      SDPA's backward (``autograd.grad`` of ``scaled_dot_product_attention``
      on a kept graph, its forward not rerun; each backend's time beside
      it), the bound from ``ops.bwd_flops`` (2 (3 D + 2 Dv) operations a
      kept (row, key) pair), Dr's, dK/dV's and dQ's ms one by one from the
      profiler in a child process, and the launches a train step;
   d. [lm-train-mesh] on 4 gloo ranks sharing cuda:0 (``phase_lm_train_mesh``):
      f32 steps held to one device (stablelm-12b on 4x1 and 2x2,
      granite-moe on 2x2 and on a 2x1x2 (pod, data, model) mesh,
      deepseek-v2 (1 layer, 16 of 160 experts), zamba2 (2 layers),
      xlstm-1.3b (2 layers) and seamless (1 + 1 layers) on 2x2, tensor
      parallel), 2-step bf16 runs of stablelm-12b (2 of 40
      layers), granite-moe (6 of 24) and zamba2 (6 of 38); rank 0 gathers each rank's block of
      every leaf and holds it to the same block of one device's.
   Each phase's wall seconds follow it on a ``[phase]`` line.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.testing import assert_canonical_close, flat_tree  # noqa: E402

F32_TOL, BF16_TOL, ATTN_TOL = 1e-4, 3e-2, 2e-4
# flash_attention's main shape in bf16: its outputs average ~i/e keys, so a
# typical |o| is ~0.05 and 3e-2 would hide a systematic error; one bf16 ulp
# of an output near 1 is 3.9e-3
ATTN_BF16_TOL = 1e-2
CONSISTENCY_TOL = 1e-2  # tests/test_archs.py: decode against forward
CARD_CPU_TOL = 1e-4  # two f32 layers, card against CPU (phase 6b)
F64_TOL = 1e-6  # xLSTM decode against forward in float64, any depth (phase 9d)
XLSTM_ULPS = 4  # xLSTM decode against forward past one segment: at most
# this many times what one ulp at the input does to forward (phase 9d)
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
    # no TPU kernel: the reference trains through the autodiff of the
    # Pallas kernel's jnp twin
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:72"),
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


def _counters() -> dict:
    """name -> (module, attribute) of each kernel's launch count; the
    backward of flash_attention counts beside its forward."""
    mods = _kernel_modules()
    out = {name: (mod, "launches") for name, mod in mods.items()}
    out["flash_attention_bwd"] = (mods["flash_attention"], "bwd_launches")
    return out


def reset_launches() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


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
        if lib == "flash_attention_bwd":
            bwd_ptxas(log)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")
    phase_sass(build)


def ptxas_report(lib: str, log: str, label, dynamic: str) -> dict:
    """ptxas's registers, shared memory and spills for each entry of
    ``lib`` that ``label(mangled name)`` names (None skips it), printed a
    line each; returns name -> [spill store bytes, spill load bytes]."""
    import re
    name, spills = None, {}
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = label(entry.group(1))
        elif name and "spill" in line:
            props = line.split(":")[-1].strip()
            spills[name] = [int(v) for v in re.findall(r"(\d+) bytes spill", props)]
        elif name and "registers" in line:
            static = re.search(r"(\d+) bytes smem", line)
            print(f"[build] {lib} {name}: {line.split(':')[-1].strip()}; "
                  f"{spills.get(name)} bytes spill stores / loads; shared memory "
                  f"{static.group(1) if static else 0} bytes static, the rest dynamic "
                  f"{dynamic}")
            name = None
    return spills


def forest_ptxas(log: str) -> None:
    """ptxas's registers, shared memory and spills for each decision_forest
    instance (ROWS rows x TREES trees a thread, rows staged or read from
    global memory); fails on a spill."""
    import re

    def label(mangled):
        entry = re.search(r"forest_kernelILi(\d)ELi(\d)ELb([01])E", mangled)
        if not entry:
            return None
        rows, trees, staged = entry.groups()
        return (f"forest_kernel<{rows} rows, {trees} trees, "
                f"{'rows staged' if staged == '1' else 'rows from global'}>")
    spills = ptxas_report("decision_forest", log, label, "from ops.forest_tiling")
    if len(spills) != 10 or any(sum(v) for v in spills.values()):
        raise AssertionError(f"decision_forest: want 10 instances, none spilling: {spills}")


BWD_PASSES = {"0": "dK+dV", "1": "dV", "2": "dK"}  # tc::dkdv's MODE


def bwd_ptxas(log: str) -> None:
    """ptxas's registers and spills for every flash_attention_bwd kernel:
    the bf16 wgmma instances (tc::dkdv<D, Dv, pass>: 5 pairs in one pass, D
    160 and (192, 128) in two; tc::dq<D, Dv>: 7), the f32 CUDA-core ones
    and Dr's; fails on a spill in any of them, and prints ptxas's warnings
    (a serialized wgmma among them)."""
    import re

    def label(mangled):
        if not mangled.startswith("_ZN3fab"):
            return None
        kernel = re.search(r"(bwd_preprocess|bwd_dkdv|bwd_dq|dkdv|dq)I", mangled).group(1)
        args = re.findall(r"Li(\d+)E", mangled)
        if kernel == "dkdv":
            return f"tc::dkdv<{args[0]}, {args[1]}, {BWD_PASSES[args[2]]}>"
        if kernel == "dq":
            return f"tc::dq<{args[0]}, {args[1]}>"
        typ = "bf16" if "bfloat16" in mangled else "f32"
        ns = "simt::" if kernel != "bwd_preprocess" else ""
        return f"{ns}{kernel}<{typ}, {', '.join(args)}>"
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"[build] flash_attention_bwd: {line.strip()}")
    spills = ptxas_report("flash_attention_bwd", log, label, "at launch")
    tc = [n for n in spills if n.startswith("tc::")]
    if len(tc) != 16 or any(sum(v) for v in spills.values()):
        raise AssertionError(f"flash_attention_bwd: want 16 wgmma instances (9 dK/dV, 7 dQ), "
                             f"none of {len(spills)} kernels spilling: {spills}")


# kernel instances that must run on tensor cores: (library, what an instance
# is named by, mangled-name pattern, instances, the instruction their SASS
# must hold, readable names of the pattern's values)
_COPIES = {"1": "16-byte", "0": "element"}
TENSOR_CORE_KERNELS = (
    ("block_matmul", "f32 copies", r"gemm_tf32x3ILb([01])E", 2, "HGMMA", _COPIES),
    ("block_matmul", "bf16 copies", r"gemm_bf16ILb([01])E", 2, "HMMA", _COPIES),
    ("fused_dense", "f32 copies", r"gemm_tf32x3ILb([01])E", 2, "HGMMA", _COPIES),
    ("fused_dense", "bf16 copies", r"gemm_bf16ILb([01])E", 2, "HMMA", _COPIES),
    ("flash_attention", "bf16 (D, Dv)", r"flash_fwd_bf16ILi(\d+)ELi(\d+)E", 7, "HGMMA", {}),
    ("flash_decode", "bf16 head dim", r"decode_tcILi(\d+)E", 5, "HMMA", {}),
    ("flash_attention_bwd", "dK/dV bf16 (D, Dv, pass)", r"2tc4dkdvILi(\d+)ELi(\d+)ELi(\d)E",
     9, "HGMMA", BWD_PASSES),
    ("flash_attention_bwd", "dQ bf16 (D, Dv)", r"2tc2dqILi(\d+)ELi(\d+)E", 7, "HGMMA", {}))


def phase_sass(build) -> None:
    """Tensor-core instructions in the SASS (cuobjdump of the built
    libraries): HGMMA (wgmma) in every f32 instance of the two GEMMs and
    every bf16 flash_attention instance and every bf16 instance of its
    backward (dK/dV and dQ at all seven pairs), HMMA (mma.sync) in every
    bf16 instance of the GEMMs and of flash_decode's sweep."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dumps = {}
    for lib, named_by, pattern, instances, want, readable in TENSOR_CORE_KERNELS:
        if lib not in dumps:
            dumps[lib] = subprocess.run([tool, "--dump-sass", str(build._lib_path(lib))],
                                        capture_output=True, text=True, check=True,
                                        timeout=120).stdout
        counts, name = {}, None
        for line in dumps[lib].splitlines():
            if "Function :" in line:
                found = re.search(pattern, line)
                name = ("/".join(readable.get(g, g) for g in found.groups())
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
def engine_calls(record):
    """Inside it, each engine kernel's wrapper calls ``record(kernel,
    shape)`` with its operand shape at each call on the card. The plans look
    the wrappers up at each call, so they go through the recorder; the
    calls and their launch counts are unchanged."""
    saved = []
    for name, (mod, attr, key) in _engine_wrappers().items():
        fn = getattr(mod, attr)

        def recorder(*a, _fn=fn, _name=name, _key=key, **kw):
            if a[0].is_cuda:
                record(_name, _key(*a, **kw))
            return _fn(*a, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, recorder)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def recording_shapes(seen: dict):
    """Inside it, each engine kernel's wrapper keeps in ``seen[kernel]`` the
    largest operand shape (by the product of its sizes) of its calls on
    the card."""
    def keep_largest(name, shape):
        if _work(shape) > _work(seen.get(name, ())):
            seen[name] = shape
    return engine_calls(keep_largest)


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


MESH_RANKS = 4  # gloo ranks time-slicing cuda:0 in [mesh]
MESH_TIMEOUT_S = 300.0  # their group's timeout


def _row_blocks(pplan, catalog, ways: int) -> dict:
    """Rows of a rank's block -> the padding rows the last rank's block of
    that size carries, for each row-partitioned node of ``pplan`` (its
    per-device capacity); the padding comes from the nearest row slice
    below it, scaled by a cross join's right side."""
    from repro_torch.core import cost
    from repro_torch.core import physical as ph
    out = {}

    def walk(node, path):
        if pplan.part_for(path).kind == "row":
            rows = cost.phys_node_info(node, pplan.registry, catalog)[1]
            sl = next(n for n in _phys_nodes(node)
                      if isinstance(n, ph.PRepartition) and n.op == "slice")
            pad = (sl.out_capacity * ways - sl.in_capacity) * (rows // sl.out_capacity)
            out[rows] = max(out.get(rows, 0), pad)
        for i, c in enumerate(node.children()):
            walk(c, f"{path}.{i}")
    walk(pplan.root, "r")
    return out


def mesh_rank(rank: int, ways: int, out_dir: str) -> None:
    """One rank of [mesh]: the 12 workloads at scale 1.0, row- and
    hash-partitioned over the ranks, through ``kernel_plan`` and through
    costed lowering's decisions, each against this rank's single-device
    run of the same realization (masks and ints exact, floats 2e-5); then
    the full-size queries through ``QueryServer(mesh=, memory_budget=)``
    against ``execute``. Launch counts are zeroed just before each
    partitioned run and read just after; the kernels' operand shapes are
    recorded. Writes its report to ``out_dir/rank{rank}.json``."""
    from repro_torch.core import cost, costed_lowering, stage_graph
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core import physical as ph
    from repro_torch.core.executor import execute
    from repro_torch.core.rules import kernel_plan
    from repro_torch.data.workloads import ALL_WORKLOADS
    from repro_torch.serving import QueryServer
    from repro_torch.testing import (PARTITION_TOL, assert_tables_equal, partition_budget,
                                     partition_flavours, replicated, run_partitioned)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mesh_util.data_mesh()
    profile = cost.default_profile("cuda")
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(KERNELS, 0)
    shapes = {k: {} for k in ENGINE_KERNELS}
    blocks: dict = {}  # rows of a rank's row block -> its tail padding

    def counted(fn):
        reset_launches()
        with engine_calls(lambda k, shape: shapes[k].update({shape: shapes[k].get(shape, 0) + 1})):
            out = fn()
        torch.cuda.synchronize()
        for k, n in read_launches().items():
            launches[k] += n
        return out

    runs = 0
    for name in sorted(ALL_WORKLOADS):
        w = ALL_WORKLOADS[name](scale=1.0, device="cuda")
        tables = dict(w.catalog.tables)
        for variant, plan in (("kernel_plan", kernel_plan(w.plan, w.catalog)),
                              ("costed", w.plan)):
            g = stage_graph.build(plan, w.catalog, profile=profile, ways=ways)
            base = (None if variant == "kernel_plan" else costed_lowering.lower_costed(
                plan, w.catalog, profile=profile, ways=ways).decisions)
            for flavour, d in partition_flavours(g, base).items():
                want = ph.run(g.realize(replicated(g, d)), tables)
                pplan = g.realize(d)
                blocks.update(_row_blocks(pplan, w.catalog, ways))
                got = counted(lambda: run_partitioned(pplan, tables, mesh))
                assert_tables_equal(want, got, f"[mesh] rank {rank} {name}/{variant}/{flavour}")
                runs += 1
    workloads_s = time.perf_counter() - t0
    served = []
    for name, scale in FULL_SIZE:
        w = ALL_WORKLOADS[name](scale=scale, device="cuda")
        plan = kernel_plan(w.plan, w.catalog)
        # these queries fit on one card: the budget is an artificial one,
        # which makes the server route them to the partitioned executable
        peak, part, budget = partition_budget(plan, w.catalog, ways, profile)
        srv = QueryServer(max_batch_size=4, max_wait_s=3600.0, mesh=mesh,
                          memory_budget=budget)
        req = srv.submit(plan, w.catalog)
        if not (req.partitioned and "#be=part" in req.key):
            raise AssertionError(f"[mesh] {name}@{scale}: not routed to the partitioned path")
        t1 = time.perf_counter()
        if counted(srv.drain) != 1 or req.error is not None:
            raise AssertionError(f"[mesh] {name}@{scale}: {req.error}")
        serve_s = time.perf_counter() - t1
        exe = srv.cache.get_or_compile_partitioned(plan, w.catalog, mesh, cache_key=req.key)
        low = costed_lowering.lower_costed(plan, w.catalog, profile=srv.cache.profile,
                                           ways=ways)
        if (exe.kind != "partitioned" or exe.pplan.ways != ways or srv.cache.traces != 1
                or low.budget_pruned_all or low.peak_memory > budget):
            raise AssertionError(f"[mesh] {name}@{scale}: served by the {exe.kind} entry "
                                 f"({exe.pplan.ways} ways, {srv.cache.traces} builds), "
                                 f"chosen peak {low.peak_memory:.4g} B against the budget "
                                 f"{budget:.4g} B")
        blocks.update(_row_blocks(exe.pplan, w.catalog, ways))
        want = execute(plan, w.catalog)
        assert_canonical_close(want.canonical(), req.result.canonical(),
                               f"[mesh] rank {rank} served {name}@{scale}", PARTITION_TOL)
        served.append({"query": f"{name}@{scale}", "peak": peak, "seed_peak": part,
                       "budget": budget, "chosen_peak": low.peak_memory,
                       "kind": exe.kind, "parts": exe.pplan.part_signature(),
                       "serve_s": serve_s})
        del w, srv, exe, want, req
    report = {
        "launches": launches, "runs": runs, "workloads_s": workloads_s,
        "seconds": time.perf_counter() - t0, "served": served,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        # per kernel: [shape, tail padding rows or None off a row block, calls]
        "shapes": {k: sorted(([list(sh), blocks.get(sh[0]), n] for sh, n in v.items()),
                             key=lambda e: -_work(tuple(e[0])))
                   for k, v in shapes.items()}}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


def mesh_kernel_parity(shapes: dict) -> None:
    """Each engine kernel against its plain version at the largest of its
    [mesh] row-block shapes with tail padding (its last rows zero, as the
    last rank's block holds them), else at its largest row-block shape, at
    its bar."""
    from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
    from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
    from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    for kernel in ENGINE_KERNELS:
        blocks = [(tuple(sh), pad) for sh, pad, _ in shapes[kernel] if pad is not None]
        if not blocks:
            raise AssertionError(f"[mesh] {kernel}: never launched on a row block")
        shape, pad = ([b for b in blocks if b[1]] or blocks)[0]
        if kernel == "decision_forest":
            n, d, t, depth = shape
            x, feat, thresh, leaf = _forest_inputs(gen, n, d, t, depth)
            x[n - pad:] = 0
            got, want = (df.forest_predict(x, feat, thresh, leaf),
                         df_ref.forest_predict(x, feat, thresh, leaf))
        else:
            m, k, n, arg = shape
            x, w = _normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5)
            x[m - pad:] = 0
            if kernel == "block_matmul":
                got, want = bm.block_matmul(x, w, arg), bm_ref.block_matmul(x, w, arg)
            else:
                b = _normal(gen, (n,))
                got, want = fd.fused_dense(x, w, b, arg), fd_ref.fused_dense(x, w, b, arg)
        err = kernel_vs_plain(got, want, F32_TOL, f"[mesh] {kernel} at {shape}")
        tail = (f"the last {pad} rows zero, the tail padding" if pad
                else "no tail padding on this path: the largest row block")
        print(f"[mesh] parity {kernel} at row block {shape} ({tail}): max|err|={err:.3g} "
              f"(bar rtol=atol={F32_TOL:g})")


def phase_mesh() -> None:
    """[mesh]: the multi-device engine on the one card. A 1-wide mesh on an
    NCCL group of one rank: the partitioned entry is the plain one and
    nothing shards. Then ``MESH_RANKS`` gloo ranks time-slicing cuda:0
    (``mesh_rank``); each rank's launches and kernel shapes, and each
    engine kernel at a tail-padded row block against its plain version.
    The times are of ranks sharing one card: they say nothing of the speed
    of several cards."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data.workloads import ALL_WORKLOADS
    from repro_torch.testing import spawn_ranks
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1, device_id=torch.device("cuda:0"),
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = mesh_util.data_mesh(1)
            w = ALL_WORKLOADS["retail_q3"](scale=1.0, device="cuda")
            cache = PlanCache(device="cuda")
            plain = cache.get_or_compile_partitioned(w.plan, w.catalog, mesh)
            if plain is not cache.get_or_compile(w.plan, w.catalog) or mesh_util.can_shard(mesh, 8):
                raise AssertionError("[mesh] a 1-wide mesh must fall back to the plain entry")
            print(f"[mesh] 1 wide: a {dist.get_backend()} group of one rank on cuda:0, "
                  f"mesh {mesh_util.mesh_signature(mesh)}: get_or_compile_partitioned is the "
                  f"plain entry, can_shard(mesh, 8) False")
            del plain, cache, w
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        # NCCL refuses two ranks on one GPU; gloo takes CUDA tensors, so the
        # ranks share cuda:0 and time-slice it
        spawn_ranks(mesh_rank, MESH_RANKS, args=(out,), device="cuda:0",
                    timeout_s=MESH_TIMEOUT_S)
        reports = [json.loads(Path(out, f"rank{r}.json").read_text())
                   for r in range(MESH_RANKS)]
    secs = time.perf_counter() - t0
    for r, rep in enumerate(reports):
        seen = {k: [f"{'x'.join(map(str, sh))}"
                    f"{'' if pad is None else f' row block, tail {pad}'}: {n}"
                    for sh, pad, n in v[:6]] for k, v in rep["shapes"].items()}
        print(f"[mesh] rank {r} kernels {json.dumps(rep['launches'])} over {rep['runs']} "
              f"partitioned workload runs and 2 served queries; shapes (largest 6, "
              f"calls each) {json.dumps(seen)}")
        missing = [k for k in ("block_matmul", "decision_forest") if rep["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"[mesh] rank {r}: kernels not launched: {missing}")
    for q in reports[0]["served"]:
        print(f"[mesh] served {q['query']} kernel plan on {MESH_RANKS} ranks: routed to "
              f"get_or_compile_partitioned, which gave the {q['kind']} executable (parts "
              f"{q['parts']}); tree-order peak {q['peak'] / 2 ** 20:.1f} MiB a device, "
              f"row-partitioned seed {q['seed_peak'] / 2 ** 20:.1f} MiB, budget halfway "
              f"{q['budget'] / 2 ** 20:.1f} MiB (artificial: the query fits on one card), "
              f"chosen plan's peak {q['chosen_peak'] / 2 ** 20:.1f} MiB; == execute at "
              f"2e-05; rank 0's dispatch {q['serve_s']:.3f} s")
    mesh_kernel_parity(reports[-1]["shapes"])
    print(f"[mesh] {MESH_RANKS} gloo ranks time-slicing cuda:0 (not a multi-card speed): "
          f"{secs:.1f} s in all, spawn included; workloads "
          + ", ".join(f"rank {r} {rep['workloads_s']:.1f} s" for r, rep in enumerate(reports))
          + "; peak memory " + ", ".join(f"rank {r} {rep['peak_bytes'] / 2 ** 30:.2f} GiB"
                                       for r, rep in enumerate(reports)))


# Decode steps after the B 4 x 2048 prefill in [lm-mesh], and the cuts of
# depth below: the mesh phases run gloo through a shared host, whose speed
# varies 2-3x between machines. On H100s (700 W) this script took 1,181 s
# of its 1,200 with 8 steps and every config at full depth, and 1,173 s
# with 4 steps and 2-step bf16 train runs (an eager 40-layer step 4.9 s).
LM_MESH_STEPS = 2
# arch, layers kept (None: all), type, (data, model) or (pod, data, model) meshes
LM_MESH_CONFIGS = (
    ("granite-3-2b", None, "bfloat16", ((1, MESH_RANKS), (2, MESH_RANKS // 2))),
    ("granite-moe-1b-a400m", 12, "bfloat16", ((1, MESH_RANKS),)),
    # tensor parallel at full width, each rank holds about a quarter
    ("stablelm-12b", 12, "bfloat16", ((1, MESH_RANKS),)),
    ("deepseek-v2-236b", 2, "float32", ((1, MESH_RANKS),)),
    ("deepseek-v2-236b", 6, "bfloat16", ((1, MESH_RANKS),)),
    ("zamba2-1.2b", None, "float32", ((1, MESH_RANKS),)),
    ("zamba2-1.2b", None, "bfloat16", ((1, MESH_RANKS),)),
    # rows over pod and data, slots over model
    ("granite-3-2b", 4, "float32", ((2, 1, MESH_RANKS // 2),)),
    # tensor parallel: one of xLSTM's 4 mLSTM heads a rank and the sLSTM
    # gates over model, on a shorter prompt (LM_MESH_PROMPTS); in float32
    # one mLSTM and one sLSTM layer (at one segment of 8 the logits move
    # 0.0179 when the embeddings move one ulp, and the mesh's other
    # association moved them 0.0375 on an H100), that segment of 8 in
    # float64 (the float32 program under ``Float64``, at ``F64_TOL``: the
    # witness that the float32 gap there is rounding), in bfloat16 two of
    # its 6 segments; 4 of the encoder-decoder's 16 heads a rank in the
    # encoder, the decoder and the cross-attention
    ("xlstm-1.3b", 2, "float32", ((1, MESH_RANKS),)),
    ("xlstm-1.3b", 8, "float64", ((1, MESH_RANKS),)),
    ("xlstm-1.3b", 16, "bfloat16", ((1, MESH_RANKS),)),
    ("seamless-m4t-medium", None, "float32", ((1, MESH_RANKS),)),
    ("seamless-m4t-medium", None, "bfloat16", ((1, MESH_RANKS),)),
)
# prompts shorter than FAMILY_PROMPT: xLSTM's sLSTM scan runs eagerly, a
# token at a time, on each of the ranks that time-slice the card
LM_MESH_PROMPTS = {"xlstm-1.3b": 512}


def _lm_mesh_cfg(arch: str, layers, dtype: str):
    """A ``[lm-mesh]`` config: full width, ``layers`` deep (the
    encoder-decoder's encoder too); float32 for ``dtype`` "float64", whose
    runs take ``_lm_mesh_mode``."""
    dtype = "float32" if dtype == "float64" else dtype
    if layers is None:
        return _family_cfg(arch, dtype)
    return _family_cfg(arch, dtype, **_depth(_family_cfg(arch), layers))


def _depth(cfg, layers: int) -> dict:
    """The fields that cut ``cfg`` to ``layers`` layers: the
    encoder-decoder's encoder as deep, xLSTM's segments no longer than the
    cut."""
    kw = {"n_layers": layers}
    if cfg.kind == "encdec":
        kw["enc_layers"] = layers
    if cfg.kind == "xlstm":
        kw["slstm_every"] = min(cfg.slstm_every, layers)
    return kw


def _lm_mesh_mode(dtype: str):
    """The context a ``[lm-mesh]`` run of ``dtype`` takes, its params made
    inside: ``Float64`` for "float64", so that the float32 program runs
    with no float32 rounding left."""
    return Float64() if dtype == "float64" else contextlib.nullcontext()


def _lm_mesh_name(arch: str, layers, dtype: str) -> str:
    return f"{arch}-{layers or 'all'}-{dtype}"


def _lm_mesh_inputs(cfg, seed: int = 21):
    """The prompt [B, 2048] (``LM_MESH_PROMPTS``' length where it names the
    arch), each step's tokens [steps, B] and prefill's other arguments (the
    encoder-decoder's frames [B, 2048, D]), from a CPU generator: the same
    in every process."""
    from repro_torch.models import lm
    gen = torch.Generator().manual_seed(seed)
    s = LM_MESH_PROMPTS.get(cfg.name, FAMILY_PROMPT)
    prompt = torch.randint(0, cfg.vocab, (FAMILY_BATCH, s), generator=gen)
    steps = torch.randint(0, cfg.vocab, (LM_MESH_STEPS, FAMILY_BATCH), generator=gen)
    kw = {}
    if cfg.kind == "encdec":
        kw["enc_embeds"] = torch.randn((FAMILY_BATCH, FAMILY_PROMPT, cfg.d_model),
                                       generator=gen).to(lm._dt(cfg)).cuda()
    return prompt.cuda(), steps.cuda(), kw


def _one_rank_logits(cfg, params: dict) -> tuple:
    """(the empty-cache step's logits [B, vocab], prefill's and each step's
    [1 + steps, B, vocab]) on one rank, float32 on the host."""
    from repro_torch.models import lm
    prompt, steps, kw = _lm_mesh_inputs(cfg)
    step = lm.make_decode_step(cfg)
    empty = step(params, lm.init_cache(cfg, FAMILY_BATCH, FAMILY_MAX_LEN, device="cuda"),
                 steps[0])[0]
    logits, cache = lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN, **kw)
    outs = [logits]
    for tok in steps:
        lg, cache = step(params, cache, tok)
        outs.append(lg)
    return (empty[:, :cfg.vocab].float().cpu(),
            torch.stack(outs)[..., :cfg.vocab].float().cpu())


def lm_mesh_one_rank(name: str, cfg, dtype: str, out_dir: str, ulp: bool) -> tuple:
    """A config's run on one rank, in this process: prefill, then
    ``LM_MESH_STEPS`` decode steps on the seeded tokens, and one step from
    an empty cache. Where ``ulp`` (``lm_mesh_bar`` reads it) it runs again
    with every embedding element moved one ulp of its type (``_ulp_moved``):
    the largest change of the logits is the run's response to one rounding
    at its input. Saves the logits (the real vocabulary, float32; float64
    under ``_lm_mesh_mode``) and the response to ``out_dir/<name>.npz`` and
    frees the rest. Returns (seconds, response)."""
    from repro_torch.models import lm
    t0 = time.perf_counter()
    with _lm_mesh_mode(dtype):
        params = lm.init_params(cfg, seed=0, device="cuda")
        empty, steps = _one_rank_logits(cfg, params)
    response = 0.0
    if ulp:
        moved = _one_rank_logits(cfg, _ulp_moved(params, seed=5))[1]
        response = float((moved - steps).abs().max())
    np.savez(Path(out_dir, f"{name}.npz"), steps=steps.numpy(), empty=empty.numpy(),
             response=np.float64(response))
    del params
    _free()
    return time.perf_counter() - t0, response


def _lm_mesh_partials(cache: dict, cfg, mesh, rank: int) -> dict:
    """The flash_decode kernel on this rank's slice of the first attention
    layer's cache (its filled slots, a seeded query) against its plain
    version. A slice with no filled slot is held to what the merge needs of
    it: m = -1e30 and finite acc and l in both, so that it weighs zero. The
    encoder-decoder's cross-attention too, at the rank's shape: its rows of
    the encoder's memory, its query heads and the KV heads they read."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.kernels.flash_decode import ops as fdec
    from repro_torch.kernels.flash_decode.ref import decode_partials_plain
    k, v = cache["k"][0], cache["v"][0]
    s_loc = k.shape[1]
    valid = min(max(int(cache["len"]) - mesh_util.rank_of(mesh, "model") * s_loc, 0), s_loc)
    gen = torch.Generator(device="cuda").manual_seed(31 + rank)
    q = _normal(gen, (k.shape[0], cfg.n_heads, cfg.hd), dtype=k.dtype)
    n = torch.tensor(valid, dtype=torch.int32, device="cuda")
    got = fdec.gqa_decode_partials(q, k, v, n)
    want = decode_partials_plain(q, k, v, n, cfg.hd ** -0.5)
    if valid:
        err = max(kernel_vs_plain(x, y, ATTN_TOL, f"[lm-mesh] rank {rank} flash_decode {part}")
                  for x, y, part in zip(got, want, ("acc", "m", "l")))
    else:
        for part, x, y in zip(("acc", "m", "l"), got, want):
            if not (bool(x.isfinite().all()) and bool(y.isfinite().all())):
                raise AssertionError(f"[lm-mesh] rank {rank}: empty slice, {part} not finite")
        if not (bool((got[1] == -1e30).all()) and bool((want[1] == -1e30).all())):
            raise AssertionError(f"[lm-mesh] rank {rank}: empty slice, m is not -1e30")
        err = 0.0
    out = {"shape": [list(q.shape), list(k.shape)], "valid": valid, "err": err,
           "empty_l": [float(got[2].max()), float(want[2].max())] if not valid else None}
    if cfg.kind == "encdec":
        from repro_torch.models import lm
        hq, _, nkv = lm._local_kv(cfg, lm._tp(cfg, mesh))
        b_loc, frames = cache["enc_h"].shape[:2]
        q = _normal(gen, (b_loc, hq, cfg.hd), dtype=k.dtype)
        ke, ve = (_normal(gen, (b_loc, frames, nkv, cfg.hd), dtype=k.dtype) for _ in range(2))
        n = torch.tensor(frames, dtype=torch.int32, device="cuda")
        out["cross"] = {"shape": [list(q.shape), list(ke.shape)], "err": max(
            kernel_vs_plain(x, y, ATTN_TOL, f"[lm-mesh] rank {rank} cross flash_decode {part}")
            for x, y, part in zip(fdec.gqa_decode_partials(q, ke, ve, n),
                                  decode_partials_plain(q, ke, ve, n, cfg.hd ** -0.5),
                                  ("acc", "m", "l")))}
    return out


def _rank_flash_attention(shapes, causal: bool, dtype, rank: int) -> float:
    """flash_attention at the shape the rank's prefill gave it (its rows,
    its query heads, the KV heads they read; ``shapes`` = q's, k's and v's
    [B, S, H, D]), on inputs seeded by the rank, against its plain version;
    outside the counted window."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(50 + rank)
    q, k, v = (_normal(gen, sh, dtype=dtype).transpose(1, 2) for sh in shapes)
    got = fa.flash_attention(q, k, v, causal)
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=causal).transpose(1, 2)
    tol = BF16_TOL if dtype == torch.bfloat16 else ATTN_TOL
    err = kernel_vs_plain(got, want, tol, f"[lm-mesh] rank {rank} flash_attention at "
                          f"{list(shapes)}, causal {causal}")
    del q, k, v, got, want
    return err


# the float32 configs held to a one-ulp bar too (``lm_mesh_bar``,
# ``_train_mesh_f32``): zamba2's Mamba-2 layers carry the other association
# of the tensor-parallel sums through their states. On an H100 (700 W) its
# 38-layer f32 logits on 1x4 were 3.03e-4 off one rank against 2e-4, with a
# one-ulp response of 2.84e-4; its 2-layer f32 step on 2x2 updated
# ``shared_attn/ln1`` 4.49e-4 of its largest update off one device's
# against 2e-4 (AdamW's first step divides each gradient element by
# |g| + eps), with a one-ulp response of 4.5e-4 (a bar of 1.8e-3). The
# same division in the encoder-decoder's and xLSTM's f32 steps on 2x2:
# seamless updated ``enc_blocks/ln1`` 2.11e-4 of its largest update off
# one device's with a one-ulp response of 2.12e-4, xLSTM ``slstm/ln``
# 5.84e-4 with 5.85e-4. Only the params take this bar: the moments hold
# the gradient itself and stay at 2e-4 (``mu`` 3.05e-6 and 4.67e-5, ``nu``
# 4.06e-6 and 9.07e-5; zamba2's 8.97e-6 and 1.53e-5). Their ``[lm-mesh]``
# logits keep 2e-4 where their own response is smaller (xLSTM's at 2
# layers: 4.33e-6).
F32_ULP_ARCHS = ("seamless-m4t-medium", "xlstm-1.3b", "zamba2-1.2b")


def ulp_bar(arch: str, dtype: str) -> bool:
    """Whether a config's bars take its one-ulp response (bfloat16, and
    ``F32_ULP_ARCHS`` in float32)."""
    return dtype == "bfloat16" or (dtype == "float32" and arch in F32_ULP_ARCHS)


def lm_mesh_bar(arch: str, dtype: str, response: float) -> float:
    """The bar of a rank's logits against one rank's: the CPU tests' LM bar
    (``testing.lm_tol``: 2e-4 in float32, 3e-2 in bfloat16); where
    ``ulp_bar`` at least ``XLSTM_ULPS`` times the one-rank run's response
    to a one-ulp move of the embeddings, as ``[lm-xlstm]`` holds depth that
    amplifies rounding. The ranks sum the MoE's combine and the
    tensor-parallel products' partials in another association than one
    device (the reference's psum does too), and a top-6-of-160 router can
    flip a near tie on one rounding. ``F64_TOL`` in float64."""
    from repro_torch.testing import lm_tol
    if dtype == "float64":
        return F64_TOL
    return max(lm_tol(dtype), XLSTM_ULPS * response if ulp_bar(arch, dtype) else 0.0)


def _lm_mesh_run(arch: str, cfg, dtype: str, mesh, want: dict, rank: int,
                 ways: int) -> dict:
    """One config on this rank of ``mesh``: the params made one rank at a
    time (each draws whole layers and keeps its experts), an empty-cache
    step, prefill(mesh=) and ``LM_MESH_STEPS`` steps through
    ``Server(mesh=)``, each held to the one-rank logits at ``lm_mesh_bar``;
    launches zeroed just before the prefill and the steps and read just
    after each; the kernel against its plain version on this rank's slice.
    ``lm_mesh_rank`` runs it under ``_lm_mesh_mode``."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.models import lm, sharding
    bar = lm_mesh_bar(arch, dtype, float(want["response"]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(ways):
        if r == rank:
            params = lm.init_params(cfg, seed=0, device="cuda", mesh=mesh)
            torch.cuda.synchronize()
        dist.barrier()
    init_s = time.perf_counter() - t0
    prompt, steps, kw = _lm_mesh_inputs(cfg)
    server = serve.Server(cfg, FAMILY_BATCH, FAMILY_MAX_LEN, device="cuda", params=params,
                          mesh=mesh)
    v = cfg.vocab
    reset_launches()
    server.decode(steps[0])  # len 0: every slice but the first rank's is empty
    empty_launches = read_launches()
    empty_err = kernel_vs_plain(server.logits[:, :v].float().cpu(),
                                torch.from_numpy(want["empty"]), bar,
                                f"[lm-mesh] rank {rank} {arch} empty-cache step")
    attend, fa_shapes = lm._attend, set()

    def recording(q, k, v, causal):  # the shapes the prefill hands the kernel
        fa_shapes.add(((tuple(q.shape), tuple(k.shape), tuple(v.shape)), causal))
        return attend(q, k, v, causal)

    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lm._attend = recording
    try:
        logits, server.cache = lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN, mesh=mesh, **kw)
    finally:
        lm._attend = attend
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_launches = read_launches()
    got, ms = [logits[:, :v].float().cpu()], []
    reset_launches()
    for tok in steps:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        server.decode(tok)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        got.append(server.logits[:, :v].float().cpu())
    step_launches = read_launches()
    if server.logits.device.type != "cuda" or server.captured is not None:
        raise AssertionError(f"[lm-mesh] rank {rank} {arch}: the step ran on "
                             f"{server.logits.device}, captured {server.captured}")
    got, ref = torch.stack(got), torch.from_numpy(want["steps"])
    rows = (got - ref).abs().amax(-1)  # [1 + steps, B]
    worst = divmod(int(rows.argmax()), rows.shape[1])
    over = int((rows > lm_mesh_bar(arch, dtype, 0.0)).sum())
    err = kernel_vs_plain(got, ref, bar, f"[lm-mesh] rank {rank} {arch} {dtype} logits "
                          f"against one rank (worst at step {worst[0]}, row {worst[1]}; "
                          f"{over} of {rows.numel()} rows past "
                          f"{lm_mesh_bar(arch, dtype, 0.0):g})")
    rows = next(k for k in ("k", "ckv", "mS") if k in server.cache)
    report = {
        "arch": arch, "mesh": list(mesh.mesh.shape), "rank": rank, "bar": bar,
        "worst": list(worst), "over": over,
        "experts_split": sharding.sharded_experts(cfg, mesh),
        "cache_block": list(server.cache[rows].shape), "len": int(server.cache["len"]),
        "prefill_launches": prefill_launches, "step_launches": step_launches,
        "empty_launches": empty_launches, "err": err, "empty_err": empty_err,
        "init_s": init_s, "prefill_s": prefill_s, "step_ms": ms,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "partials": _lm_mesh_partials(server.cache, cfg, mesh, rank) if rows == "k" else None,
        "fa_shapes": sorted(fa_shapes),
        "fa_err": [_rank_flash_attention(sh, causal, lm._dt(cfg), rank)
                   for sh, causal in sorted(fa_shapes)]}
    del params, server, logits, prompt, steps, kw
    _free()
    return report


def mesh_launches(cfg) -> tuple:
    """(flash_attention launches of a prefill, flash_decode of a decode
    step, flash_decode of a step from an empty cache) on each rank: a layer
    of attention each (the hybrid's shared-block applications; the
    encoder-decoder's encoder, self- and cross-attention, whose empty
    encoder memory launches none); MLA's decode attends in its latent
    space, xLSTM has no attention."""
    from repro_torch.models import lm
    if cfg.kind == "xlstm":
        return 0, 0, 0
    if cfg.kind == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers, cfg.n_layers
    n = lm._n_attn(cfg) if cfg.kind == "hybrid" else cfg.n_layers
    return (n, 0, 0) if cfg.attn == "mla" else (n, n, n)


def lm_mesh_rank(rank: int, ways: int, out_dir: str) -> None:
    """One rank of [lm-mesh]: every config of ``LM_MESH_CONFIGS`` on each of
    its meshes (``_lm_mesh_run``); writes its reports to
    ``out_dir/lm-rank{rank}.json``."""
    from repro_torch.testing import host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reports = []
    for arch, layers, dtype, shapes in LM_MESH_CONFIGS:
        cfg = _lm_mesh_cfg(arch, layers, dtype)
        with np.load(Path(out_dir, f"{_lm_mesh_name(arch, layers, dtype)}.npz")) as z:
            want = {k: z[k] for k in z.files}
        for shape in shapes:
            mesh = host_mesh(shape, device="cuda")
            with _lm_mesh_mode(dtype):
                reports.append(_lm_mesh_run(arch, cfg, dtype, mesh, want, rank, ways))
    Path(out_dir, f"lm-rank{rank}.json").write_text(json.dumps(reports))


def phase_lm_mesh() -> None:
    """[lm-mesh]: the LM on a (data, model) mesh of ``MESH_RANKS`` gloo ranks
    time-slicing cuda:0. Each config runs first on one rank here
    (``lm_mesh_one_rank``), then on the ranks (``lm_mesh_rank``); per rank
    and config: the launches (flash_attention in the prefill, flash_decode
    in the steps; a GQA or hybrid step must launch flash_decode on every
    rank), the logits' largest |err| against one rank, the kernel on the
    rank's slice against its plain version, seconds, ms per eager step and
    peak memory. The times are of ranks sharing one card: they say nothing
    of the speed of several cards."""
    import tempfile
    from repro_torch.models import lm
    from repro_torch.testing import mesh_tag, spawn_ranks
    _free()
    with tempfile.TemporaryDirectory() as out:
        for arch, layers, dtype, shapes in LM_MESH_CONFIGS:
            cfg = _lm_mesh_cfg(arch, layers, dtype)
            ulp = ulp_bar(arch, dtype)
            secs, response = lm_mesh_one_rank(_lm_mesh_name(arch, layers, dtype), cfg, dtype,
                                              out, ulp)
            full = _family_cfg(arch)
            enc = (f" (and {cfg.enc_layers} of {full.enc_layers} encoder layers over "
                   f"{FAMILY_PROMPT} frames)" if cfg.kind == "encdec" else "")
            print(f"[lm-mesh] {arch} {dtype} full width, {cfg.n_layers} of {full.n_layers} "
                  f"layers{enc} ({cfg.param_count() / 1e9:.2f} B params): one rank, prefill "
                  f"B{FAMILY_BATCH} x {LM_MESH_PROMPTS.get(arch, FAMILY_PROMPT)} (max_len "
                  f"{FAMILY_MAX_LEN}), "
                  f"{LM_MESH_STEPS} steps and an empty-cache step, {secs:.1f} s"
                  + (f"; response to a one-ulp move of the embeddings {response:.3g}, bar "
                     f"{lm_mesh_bar(arch, dtype, response):.3g}" if ulp else "")
                  + "; meshes " + ", ".join(mesh_tag(sh) for sh in shapes))
        t0 = time.perf_counter()
        spawn_ranks(lm_mesh_rank, MESH_RANKS, args=(out,), device="cuda:0",
                    timeout_s=MESH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        reports = [json.loads(Path(out, f"lm-rank{r}.json").read_text())
                   for r in range(MESH_RANKS)]
    for i, (arch, layers, dtype) in enumerate(
            (a, ly, dt) for a, ly, dt, shapes in LM_MESH_CONFIGS for _ in shapes):
        cfg = _lm_mesh_cfg(arch, layers, dtype)
        n_fa, n_fd, n_empty = mesh_launches(cfg)
        for r in range(MESH_RANKS):
            rep = reports[r][i]
            fa, fd = rep["prefill_launches"], rep["step_launches"]
            want = {"flash_attention": n_fa, "flash_decode": n_fd * LM_MESH_STEPS}
            got = {"flash_attention": fa["flash_attention"], "flash_decode": fd["flash_decode"]}
            if got != want or rep["empty_launches"]["flash_decode"] != n_empty:
                raise AssertionError(f"[lm-mesh] rank {r} {arch} {rep['mesh']}: launches "
                                     f"{got} (empty step {rep['empty_launches']}), want {want}")
            p = rep["partials"]
            part = ("no attention kernel: xLSTM" if cfg.kind == "xlstm" else
                    "no kernel: MLA attends in its latent space" if p is None else
                    f"flash_decode on its slice (q {p['shape'][0]}, k/v {p['shape'][1]}, "
                    f"{p['valid']} filled) == plain, max|err|={p['err']:.3g} (bar {ATTN_TOL:g})"
                    + ("" if p["valid"] else
                       f"; empty slice: m -1e30 in both, l {p['empty_l'][0]:g} (kernel) / "
                       f"{p['empty_l'][1]:g} (plain), weight 0 in the merge")
                    + ("" if "cross" not in p else
                       f"; cross-attention on its rows and heads (q {p['cross']['shape'][0]}, "
                       f"k/v {p['cross']['shape'][1]}) == plain, "
                       f"max|err|={p['cross']['err']:.3g}"))
            steps = sorted(rep["step_ms"])
            fa_at = "; ".join(f"q {q}, k {k}, v {v}{' causal' if causal else ''}: == plain, "
                              f"max|err|={e:.3g}"
                              for ((q, k, v), causal), e in zip(rep["fa_shapes"], rep["fa_err"]))
            print(f"[lm-mesh] {arch} {dtype} {cfg.n_layers} layers, mesh "
                  f"{mesh_tag(rep['mesh'])} rank {r}: experts "
                  f"{'split over model' if rep['experts_split'] else 'whole' if cfg.moe else '-'}"
                  f", cache block {rep['cache_block']}; launches prefill "
                  f"{json.dumps({k: v for k, v in fa.items() if v})}, {LM_MESH_STEPS} steps "
                  f"{json.dumps({k: v for k, v in fd.items() if v})}; logits vs one rank "
                  f"max|err|={rep['err']:.3g} (worst at step {rep['worst'][0]}, row "
                  f"{rep['worst'][1]}; {rep['over']} of {FAMILY_BATCH * (LM_MESH_STEPS + 1)} rows past "
                  f"{lm_mesh_bar(arch, dtype, 0.0):g}), empty-cache step {rep['empty_err']:.3g} (bar "
                  f"{rep['bar']:.3g}); {part}; "
                  + (f"flash_attention at the rank's shapes in the prefill (B, S, H, D) "
                     f"{fa_at}; " if fa_at else "")
                  + f"init {rep['init_s']:.1f} s, prefill "
                  f"{rep['prefill_s']:.2f} s, eager step median {steps[len(steps) // 2]:.1f} ms "
                  f"(min {steps[0]:.1f}), peak {rep['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"[lm-mesh] {MESH_RANKS} gloo ranks time-slicing cuda:0 (not a multi-card speed): "
          f"{secs:.1f} s, spawn included")


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


def _cut_layers(params: dict, cut, device=None) -> dict:
    """``params`` cut to the config ``cut`` (fewer layers): each stacked
    group to the leading size ``lm.param_shapes(cut)`` gives it (a shared
    block's unstacked weights stay whole), on ``device`` (by default where
    they are)."""
    from repro_torch.models import lm
    shapes = lm.param_shapes(cut)
    return {k: ({kk: w[:shapes[k][kk][0]].to(device or w.device) for kk, w in v.items()}
                if isinstance(v, dict) else v.to(device or v.device))
            for k, v in params.items()}


def card_vs_cpu(label: str, cfg, params: dict, n_layers: int, tokens, **kw) -> float:
    """``forward`` of the first layers of ``params`` (float32, full width)
    on the card (the kernels) and on the CPU (the plain versions)."""
    from repro_torch.models import lm
    cut = dataclasses.replace(cfg, n_layers=n_layers,
                              enc_layers=n_layers if cfg.enc_layers else 0)
    two = _cut_layers(params, cut)
    on_card = lm.forward(two, cut, tokens, **kw).cpu()
    two_cpu = _cut_layers(params, cut, "cpu")
    on_cpu = lm.forward(two_cpu, cut, tokens.cpu(),
                        **{k: v.cpu() for k, v in kw.items()})
    err = kernel_vs_plain(on_card, on_cpu, CARD_CPU_TOL, f"{label} card vs cpu")
    print(f"[{label}] card vs CPU, {n_layers}{'+' + str(n_layers) if cfg.enc_layers else ''} "
          f"layers at full width, f32, B{tokens.shape[0]} x {tokens.shape[1]} tokens: "
          f"hidden states max|err|={err:.3g} (bar rtol=atol={CARD_CPU_TOL:g})")
    return err


def decode_eager_vs_captured(label: str, cfg, params: dict, cache: dict, tok0,
                             max_len: int):
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
    server = serve.Server(cfg, batch=tok0.shape[0], max_len=max_len, device="cuda",
                          params=params)
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
    server, err = decode_eager_vs_captured(LM_ARCH, cfg, params, cache, tok0, LM_MAX_LEN)
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
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype=dtype, **kw)


def _free(*_) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def family_main_path(label: str, cfg, params: dict, prompt, also: tuple = (),
                     n_attn: int = 1, want: dict = None, **kw) -> dict:
    """A family's LM main path in bfloat16: prefill ``prompt`` (max_len
    ``FAMILY_MAX_LEN``), then ``decode_eager_vs_captured``; launch counts
    zeroed just before and read just after (prefill's flash_attention calls,
    and per decode step ``n_attn`` flash_decode calls a layer: the eager
    steps' and the capture's warm-up and capture, never a replay; ``want``
    gives the counts where the layers are not all attention layers)."""
    from repro_torch.models import lm
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits, cache = lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN, **kw)
    tok0 = logits.argmax(-1)
    server, err = decode_eager_vs_captured(label, cfg, params, cache, tok0, FAMILY_MAX_LEN)
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    encdec = cfg.kind == "encdec"  # prefill: encoder, self- and cross-attention
    check_launches(label, launches, want or {
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


def forward_logits(cfg, params: dict, prompt):
    """forward(prompt)'s last logits [B, vocab]."""
    from repro_torch.models import lm
    h = lm.forward(params, cfg, prompt)[:, -1]
    return (h.float() @ params["embed"].float().T)[:, :cfg.vocab]


def decode_and_forward(cfg, params: dict, prompt):
    """forward(prompt)'s last logits and those of prefill(prompt[:, :-1])
    + one decode step (tests/test_archs.py's pair), each [B, vocab]."""
    from repro_torch.models import lm
    full = forward_logits(cfg, params, prompt)
    _, cache = lm.prefill(params, cfg, prompt[:, :-1], max_len=prompt.shape[1])
    dec, cache = lm.make_decode_step(cfg)(params, cache, prompt[:, -1])
    if int(cache["len"]) != prompt.shape[1]:
        raise AssertionError(f"{cfg.name}: decode left len {int(cache['len'])}")
    return full, dec[:, :cfg.vocab]


def decode_vs_forward(cfg, params: dict, prompt, bar=CONSISTENCY_TOL) -> float:
    """prefill(prompt[:, :-1]) + one decode step against forward(prompt)'s
    last logits; fails past ``bar``."""
    full, dec = decode_and_forward(cfg, params, prompt)
    err = float((dec - full).abs().max())
    if not err < bar:
        raise AssertionError(f"{cfg.name} f32: decode/forward mismatch {err}")
    return err


def _ulp_moved(params: dict, seed: int = 0) -> dict:
    """``params`` with every embedding element moved one ulp of its type,
    up or down at random: one rounding at the stack's input."""
    e = params["embed"]
    gen = torch.Generator(device=e.device).manual_seed(seed)
    up = torch.randint(0, 2, e.shape, generator=gen, device=e.device).bool()
    inf = torch.tensor(float("inf"), dtype=e.dtype, device=e.device)
    return dict(params, embed=torch.nextafter(e, torch.where(up, inf, -inf)))


class Float64(torch.overrides.TorchFunctionMode):
    """The port's float32 arithmetic in float64: inside, a tensor made or
    cast as float32 (``dtype=torch.float32``, ``.float()``,
    ``.to(torch.float32)``) is made float64 instead, and an op that still
    returns a float32 tensor raises, so no float32 rounding is left (a
    tensor on the meta device holds no values: only its shape is read)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        f64 = (lambda a: torch.float64 if a is torch.float32 else a)
        out = func(*map(f64, args), **{k: f64(v) for k, v in (kwargs or {}).items()})
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32 and not t.is_meta:
                raise AssertionError(f"{func} returned float32 under Float64")
        return out


def drop_share(label: str, cfg, params: dict, prompt) -> None:
    """The share of routed assignments a bf16 prefill of ``prompt`` drops
    (past an expert's capacity), from the router's choices in each layer."""
    from repro_torch.models import layers as L, lm
    t = prompt.numel()
    counts, route = [], L.route
    with counting(L, "route", counts, key=lambda x, rw, k: torch.bincount(
            route(x, rw, k)[1].flatten(), minlength=cfg.moe.n_experts)):
        lm.prefill(params, cfg, prompt, FAMILY_MAX_LEN)
    cap = L.capacity(cfg, t)
    dropped = sum(int(torch.clamp(c - cap, min=0).sum()) for c in counts)
    total = len(counts) * t * cfg.moe.top_k
    print(f"[{label}] bf16 prefill of B{prompt.shape[0]} x {prompt.shape[1]} = {t} tokens: "
          f"capacity {cap} slots an expert of {cfg.moe.n_experts}; {dropped} of {total} "
          f"routed assignments dropped over {len(counts)} layers "
          f"({100 * dropped / total:.3f}%)")


def phase_lm_moe() -> None:
    """[lm-moe]: granite-moe-1b-a400m at full width and depth (24 layers,
    d 1024, 16/8 heads, 32 experts top-8, d_expert 512)."""
    from repro_torch.models import layers as L, lm
    arch = "granite-moe-1b-a400m"
    cfg32 = _family_cfg(arch, "float32")
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 2, 64)  # 128 tokens: every assignment kept
    err = decode_vs_forward(cfg32, params, prompt)
    print(f"[lm-moe] {arch} f32 full width and depth ({cfg32.n_layers} layers, "
          f"{cfg32.param_count() / 1e9:.2f} B params): prefill(prompt[:, :-1]) + 1 decode "
          f"step == forward's last logits, B2 x 64 (t <= {L.DROPLESS_TOKENS}, dropless), "
          f"max|err|={err:.3g} (bar {CONSISTENCY_TOL:g})")
    card_vs_cpu("lm-moe", cfg32, params, 2, prompt)
    del params
    _free()

    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    drop_share("lm-moe", cfg, params, prompt)
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


MLA_LAYERS = 6  # deepseek-v2-236b: 6 of 60 layers (about 48.7 GB of bf16 weights)
MLA_F32_EXPERTS = 16  # the f32 checks' deepseek-v2 layer: 16 of 160 experts


def phase_mla_attention() -> None:
    """[parity] flash_attention at MLA's (D, Dv) pairs: deepseek-v2's prefill
    (B 4, S 2048, 128 heads, all KV heads, Dqk 192, Dv 128, causal) and the
    narrow (64, 32) pair at the same shape, in float32 (bar 2e-4) and bf16
    (bar 1e-2) against the plain version; the bf16 kernel's time beside one
    SDPA call's, and each SDPA backend's time where it takes the inputs
    (Dv != Dqk rules some out), so that the default's backend shows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(10)
    b, s, h = FAMILY_BATCH, FAMILY_PROMPT, 128
    form, (_, bytes_peak, bf16_peak, _) = card_peaks(torch.cuda.get_device_name(0))
    for d, dv in ((192, 128), (64, 32)):
        errs = {}
        for dtype, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16, ATTN_BF16_TOL)):
            q, k = (_normal(gen, (b, s, h, d), dtype=dtype).transpose(1, 2) for _ in range(2))
            v = _normal(gen, (b, s, h, dv), dtype=dtype).transpose(1, 2)
            got = fa.flash_attention(q, k, v, True)
            want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), causal=True).transpose(1, 2)
            errs[dtype] = kernel_vs_plain(got, want, tol, f"flash_attention MLA {(d, dv)} {dtype}")
            del got, want
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        # which backend the default call ran: each one's time where it
        # takes these inputs (the default's time is one of them)
        backends = []
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
            short = name.split("_")[0].lower()
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    t = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
                backends.append(f"{short} {t:.4f} ms")
            except RuntimeError:
                backends.append(f"{short} refuses")
        flops = 2.0 * (d + dv) * b * h * s * (s + 1) / 2
        nbytes = 2.0 * b * h * s * (2 * d + 2 * dv)
        t_ops, t_bytes = flops / bf16_peak * 1e3, nbytes / bytes_peak * 1e3
        print(f"[parity] flash_attention MLA prefill (D {d}, Dv {dv}): B{b} Hq{h} Hkv{h} "
              f"S{s} causal: f32 max|err|={errs[torch.float32]:.3g} (bar {ATTN_TOL:g}), bf16 "
              f"max|err|={errs[torch.bfloat16]:.3g} (bar rtol=atol={ATTN_BF16_TOL:g}); bf16 "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * max(t_ops, t_bytes) / ms:.1f}% of the bound), SDPA {sdpa:.4f} ms "
              f"(by backend: {', '.join(backends)}); bound "
              f"{max(t_ops, t_bytes):.4f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} ({form} peaks; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB)")
        del q, k, v
        _free()


def phase_lm_mla() -> None:
    """[lm-mla]: deepseek-v2-236b at full width (d 5120, 128 heads, MLA
    kv_lora 512 / q_lora 1536 / rope 64 / nope 128 / v 128, 160 experts top-6
    and 2 shared, d_expert 1536, vocab 102,400), depth cut to 6 of 60 layers.
    The f32 checks run one full-width layer with 16 of its 160 experts: one
    full layer is 16 GB in f32, which the CPU side would hold twice."""
    from repro_torch.models import layers as L, lm
    arch = "deepseek-v2-236b"
    gen = torch.Generator(device="cuda").manual_seed(11)
    full = _family_cfg(arch)
    cfg32 = _family_cfg(arch, "float32", n_layers=1,
                        moe=dataclasses.replace(full.moe, n_experts=MLA_F32_EXPERTS))
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 2, 64)  # 128 tokens: every assignment kept
    err = decode_vs_forward(cfg32, params, prompt)
    print(f"[lm-mla] {arch} f32 at full width, cut to 1 layer and {MLA_F32_EXPERTS} of "
          f"{full.moe.n_experts} experts ({cfg32.param_count() / 1e9:.2f} B params): "
          f"prefill(prompt[:, :-1]) + 1 decode step (absorbed latent attention) == "
          f"forward's last logits, B2 x 64 (t <= {L.DROPLESS_TOKENS}, dropless), "
          f"max|err|={err:.3g} (bar {CONSISTENCY_TOL:g})")
    card_vs_cpu("lm-mla", cfg32, params, 1, prompt[:1])
    del params
    _free()

    cfg = _family_cfg(arch, n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[lm-mla] {arch} bf16 full width, {MLA_LAYERS} of {full.n_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; all "
          f"{full.n_layers} would be {full.param_count() * 2 / 1e9:.0f} GB), made in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    drop_share("lm-mla", cfg, params, prompt)
    family_main_path("lm-mla", cfg, params, prompt, also=("fa::",),
                     want={"flash_attention": MLA_LAYERS, "flash_decode": 0})
    del params
    _free()


def phase_lm_hybrid() -> None:
    """[lm-hybrid]: zamba2-1.2b, nothing cut (38 Mamba-2 layers, d 2048, the
    shared attention + MLP block of 32 heads after every 6 layers and the
    last 2: 7 applications)."""
    from repro_torch.models import lm
    arch = "zamba2-1.2b"
    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg32 = _family_cfg(arch, "float32")
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 2, 64)
    err = decode_vs_forward(cfg32, params, prompt)
    n_attn = lm._n_attn(cfg32)
    print(f"[lm-hybrid] {arch} f32 full width and depth ({cfg32.n_layers} Mamba-2 layers, "
          f"{n_attn} shared-block applications, {cfg32.param_count() / 1e9:.2f} B params): "
          f"prefill(prompt[:, :-1]) + 1 decode step == forward's last logits, B2 x 64, "
          f"max|err|={err:.3g} (bar {CONSISTENCY_TOL:g})")
    card_vs_cpu("lm-hybrid", cfg32, params, 2, prompt[:1])  # 2 layers, then the block
    del params
    _free()

    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    family_main_path("lm-hybrid", cfg, params, prompt, also=("fa::", "fdk::"),
                     want={"flash_attention": n_attn,
                           "flash_decode": n_attn * (LM_STEPS + 2)})
    del params
    _free()


def phase_lm_xlstm() -> None:
    """[lm-xlstm]: xlstm-1.3b, nothing cut (48 layers: 6 segments of 7
    mLSTM layers and 1 sLSTM layer, d 2048, 4 heads of 1024). Prefill's
    sLSTM is a sequential scan over the prompt's 2,048 tokens in each
    segment, as in the reference; no kernel runs on this path.

    Decode against forward at 8 (one segment), 16 and 48 layers, in float32
    and in float64 (``Float64``): at one segment within 1e-2 (f32) and
    ``F64_TOL`` (f64). Deeper, random weights amplify any rounding with
    depth (the mLSTM normalizer's division, the sLSTM's exponential
    gates), so each is held to the larger of that bar and ``XLSTM_ULPS``
    times the change in forward's last logits when the embeddings move one
    ulp of the type (``_ulp_moved``), read at the same depth; float32's
    forward against float64's is printed beside them. Card against CPU at
    1e-4 runs one mLSTM and one sLSTM layer at full width."""
    from repro_torch.models import lm
    arch = "xlstm-1.3b"
    gen = torch.Generator(device="cuda").manual_seed(13)
    cfg32 = _family_cfg(arch, "float32")
    params = lm.init_params(cfg32, seed=0, device="cuda")
    prompt = _prompt(gen, cfg32, 2, 64)
    seg, lines = cfg32.slstm_every, []
    for depth in (seg, 2 * seg, cfg32.n_layers):
        cut = dataclasses.replace(cfg32, n_layers=depth)
        p32 = _cut_layers(params, cut)
        p64 = {k: {kk: w.double() for kk, w in v.items()} if isinstance(v, dict)
               else v.double() for k, v in p32.items()}
        read = {}
        for name, p in (("f32", p32), ("f64", p64)):
            with Float64() if name == "f64" else contextlib.nullcontext():
                full, dec = decode_and_forward(cut, p, prompt)
                moved = forward_logits(cut, _ulp_moved(p), prompt)
            read[name] = (full, float((dec - full).abs().max()),
                          float((moved - full).abs().max()))
        del p, p32, p64
        rounding = float((read["f32"][0].double() - read["f64"][0]).abs().max())
        for name, tol in (("f64", F64_TOL), ("f32", CONSISTENCY_TOL)):
            _, err, ulp = read[name]
            bar = tol if depth == seg else max(tol, XLSTM_ULPS * ulp)
            lines.append(f"{depth} layers {name} {err:.3g} (bar {bar:.3g}, one ulp {ulp:.3g})")
            if not err < bar:
                raise AssertionError(f"{arch} at {depth} layers: {name} decode/forward "
                                     f"mismatch {err} (bar {bar})")
        lines[-1] += f", f32 forward against f64 {rounding:.3g}"
    print(f"[lm-xlstm] {arch} full width ({cfg32.param_count() / 1e9:.2f} B params): "
          f"prefill(prompt[:, :-1]) + 1 decode step against forward's last logits, B2 x 64, "
          f"max|err| by depth; at one segment f64 bar {F64_TOL:g}, f32 {CONSISTENCY_TOL:g}, "
          f"deeper the larger of that and {XLSTM_ULPS:g}x forward's change when the "
          f"embeddings move one ulp: " + "; ".join(lines))
    # one mLSTM and one sLSTM layer at full width
    card_vs_cpu("lm-xlstm", dataclasses.replace(cfg32, slstm_every=2), params, 2, prompt[:1])
    del params
    _free()

    cfg = _family_cfg(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = _prompt(gen, cfg, FAMILY_BATCH, FAMILY_PROMPT)
    family_main_path("lm-xlstm", cfg, params, prompt,
                     want={"flash_attention": 0, "flash_decode": 0})
    del params
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


# ---------------------------------------------------------------------------
# 10. LM training
# ---------------------------------------------------------------------------

BWD_TEST_SHAPES = [(2, 4, 2, 37, 37), (1, 4, 1, 130, 130), (1, 2, 2, 70, 45)]  # B Hq Hkv S Skv
BWD_MAIN_SHAPES = {  # label -> (B, Hq, Hkv, S, Skv, D, Dv, causal)
    "granite-3-2b": (4, 32, 8, 2048, 2048, 64, 64, True),
    "deepseek-v2 MLA": (1, 128, 128, 2048, 2048, 192, 128, True),
    "seamless cross": (4, 16, 16, 2048, 1000, 64, 64, False),
}
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 8, 4, 2048, 2
TRAIN_GRAD_TOL = 2e-4  # card vs CPU: each gradient leaf against its largest |g|
TRAIN_LOSS_TOL = 1e-4
RESUME_RTOL = 1e-5  # tests/test_train_infra.py::test_train_resume_bit_identical


def _bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, dtype):
    """q, k, v and an output cotangent do as [B,H,S,D] views of [B,S,H,D]
    tensors, as the model hands them in."""
    return [_normal(gen, sh, dtype=dtype).transpose(1, 2)
            for sh in ((b, s, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv), (b, s, hq, dv))]


def _plain_bwd(q, k, v, do, causal):
    """The plain forward's o and lse and the plain backward's gradients,
    in the wrapper's [B,H,S,*] layout."""
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_plain,
                                                        flash_attention_plain)
    t = lambda x: x.transpose(1, 2)
    o, lse = flash_attention_plain(t(q), t(k), t(v), causal=causal, return_lse=True)
    grads = flash_attention_bwd_plain(t(q), t(k), t(v), o, lse, t(do), causal)
    return t(o), t(lse), [t(g) for g in grads]


def bwd_vs_plain(inputs, causal: bool, tol: float, label: str) -> tuple:
    """The backward kernels against the plain backward on the plain
    forward's o and lse; returns the largest |err| of dq, dk and dv and
    the largest |err| over the bar."""
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v, do = inputs
    o, lse, want = _plain_bwd(q, k, v, do, causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    layout = lambda t: [st for st, n in zip(t.stride(), t.shape) if n > 1]
    for name, g, x in zip(("dq", "dk", "dv"), got, (q, k, v)):
        if g.shape != x.shape or layout(g) != layout(x) or g.dtype != x.dtype:
            raise AssertionError(f"{label} {name}: {tuple(g.shape)} {g.stride()} {g.dtype} "
                                 f"for {tuple(x.shape)} {x.stride()} {x.dtype}")
    return (max(kernel_vs_plain(g, w, tol, f"{label} {name}")
                for g, w, name in zip(got, want, ("dq", "dk", "dv"))),
            max(bar_ratio(g, w, tol) for g, w in zip(got, want)))


def phase_attention_bwd_parity() -> dict:
    """10a: flash_attention's backward kernels against the plain backward."""
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = 0
    for d, dv in sorted(fa.HEAD_DIMS):
        for b, hq, hkv, s, skv in BWD_TEST_SHAPES:
            for causal in (True, False):
                for dtype, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16, BF16_TOL)):
                    bwd_vs_plain(_bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, dtype), causal,
                                 tol, f"flash_attention backward {(b, hq, hkv, s, skv, d, dv)} "
                                 f"causal={causal} {dtype}")
                    n += 1
    print(f"[parity] flash_attention backward ok: {n} cases, every instantiated (D, Dv) "
          f"pair {sorted(fa.HEAD_DIMS)} x {len(BWD_TEST_SHAPES)} test shapes x causal and "
          f"not x f32 (bar {ATTN_TOL:g}) and bf16 (bar {BF16_TOL:g})")
    errs = {}
    for label, (b, hq, hkv, s, skv, d, dv, causal) in BWD_MAIN_SHAPES.items():
        inputs = _bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, torch.bfloat16)
        err, ratio = bwd_vs_plain(inputs, causal, BF16_TOL, f"flash_attention backward {label}")
        note = ""
        if label == "granite-3-2b":
            errs["flash_attention_bwd"] = err
            q, k, v, do = inputs
            o, lse = fa._forward(q, k, v, True, with_lse=True)
            if not torch.equal(o, fa.flash_attention(q, k, v, True)):
                raise AssertionError("flash_attention: the forward with lse differs from "
                                     "the forward without it")
            _, lse_plain, _ = _plain_bwd(q, k, v, do, True)
            lse_err = kernel_vs_plain(lse, lse_plain, ATTN_TOL, "flash_attention lse")
            first = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
            second = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError("flash_attention backward: two calls differ")
            note = (f"; two calls bit-equal; the forward with lse bit-equal to the forward "
                    f"without it, lse max|err|={lse_err:.3g} against the plain version's "
                    f"(bar {ATTN_TOL:g})")
            del first, second, o, lse
        print(f"[parity] flash_attention backward {label} B{b} Hq{hq} Hkv{hkv} S{s} Skv{skv} "
              f"D{d} Dv{dv} causal={causal} bf16: max|err|={err:.3g} (bar rtol=atol="
              f"{BF16_TOL:g}; largest |err| / (atol + rtol |want|) = {ratio:.3f}){note}")
        del inputs
        _free()
    return errs


def _tree_to(tree, device):
    from repro_torch.train.optim import tree_map
    return tree_map(lambda w: w.to(device), tree)


def train_card_vs_cpu(label: str, cfg, b: int, s: int, seed: int = 0) -> None:
    """One step's loss and gradients in f32 through the kernels on the card
    against the plain versions on the CPU, from the same weights and
    batch; then one ``make_train_step`` on each, whose parameters after
    the AdamW update are held leaf by leaf at ``TRAIN_GRAD_TOL`` of the
    leaf's largest |w|. AdamW's eps is 1e-3 there (as in the CPU tests): a
    first step moves a weight by about lr * sign(g), so with a tiny eps a
    gradient element within rounding of zero would flip a whole step."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.optim import AdamW, tree_leaves
    p_cpu = lm.init_params(cfg, seed, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    b_cpu = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(vocab=cfg.vocab, batch=b, seq=s, seed=seed).next_batch().items()}
    b_gpu = _tree_to(b_cpu, "cuda")
    reset_launches()
    loss_g, grads_g = lm.value_and_grad(p_gpu, cfg, b_gpu)
    torch.cuda.synchronize()
    launched = read_launches()
    loss_c, grads_c = lm.value_and_grad(p_cpu, cfg, b_cpu)
    kernel_vs_plain(loss_g.cpu(), loss_c, TRAIN_LOSS_TOL, f"[lm-train] {label} loss")
    worst = 0.0
    for i, (g, c) in enumerate(zip(tree_leaves(grads_g), tree_leaves(grads_c))):
        scale = float(c.abs().max())
        torch.testing.assert_close(g.cpu(), c, rtol=TRAIN_GRAD_TOL,
                                   atol=TRAIN_GRAD_TOL * max(scale, 1e-30),
                                   msg=lambda m: f"[lm-train] {label} gradient leaf {i}: {m}")
        worst = max(worst, float((g.cpu() - c).abs().max()) / max(scale, 1e-30))
    if launched["flash_attention_bwd"] <= 0:
        raise AssertionError(f"[lm-train] {label}: no backward launch {launched}")
    del grads_g, grads_c
    opt = AdamW(lr=1e-2, eps=1e-3)
    step = lm.make_train_step(cfg, opt)
    n_leaves = len(tree_leaves(p_cpu))
    p_gpu, _, m_g = step(p_gpu, opt.init(p_gpu), b_gpu)
    p_cpu, _, m_c = step(p_cpu, opt.init(p_cpu), b_cpu)
    worst_w = 0.0
    for i, (w, c) in enumerate(zip(tree_leaves(p_gpu), tree_leaves(p_cpu))):
        scale = float(c.abs().max())
        torch.testing.assert_close(w.cpu(), c, rtol=TRAIN_GRAD_TOL,
                                   atol=TRAIN_GRAD_TOL * max(scale, 1e-30),
                                   msg=lambda m: f"[lm-train] {label} updated leaf {i}: {m}")
        worst_w = max(worst_w, float((w.cpu() - c).abs().max()) / max(scale, 1e-30))
    print(f"[lm-train] {label} f32 B{b} x S{s}: card loss {float(loss_g):.6f} vs CPU "
          f"{float(loss_c):.6f} (bar {TRAIN_LOSS_TOL:g}); gradients, worst leaf "
          f"max|err| / max|g| = {worst:.3g} (bar {TRAIN_GRAD_TOL:g}, "
          f"{n_leaves} leaves); make_train_step (AdamW lr 1e-2, eps 1e-3) loss card "
          f"{float(m_g['loss']):.6f} vs CPU {float(m_c['loss']):.6f}, parameters "
          f"after the update, worst leaf max|err| / max|w| = {worst_w:.3g} (bar "
          f"{TRAIN_GRAD_TOL:g}); launches of one loss and gradient "
          f"{json.dumps({k: v for k, v in launched.items() if v})}")
    del p_gpu, p_cpu
    _free()


def phase_lm_train(card: str) -> dict:
    """10b. Returns the full-depth run's launch counts (8 steps)."""
    import tempfile
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.loop import train
    from repro_torch.train.optim import AdamW
    cfg = get_config(LM_ARCH)
    train_card_vs_cpu(f"{LM_ARCH} full width, 2 layers",
                      dataclasses.replace(cfg, dtype="float32", n_layers=2), 2, 128)
    mla = get_smoke_config("deepseek-v2-236b")
    mla = dataclasses.replace(mla, dtype="float32", remat=True, mla=dataclasses.replace(
        mla.mla, nope_dim=48, rope_dim=16, v_dim=32))  # the kernel's (64, 32) pair
    train_card_vs_cpu("deepseek-v2-236b smoke, (D, Dv) = (64, 32), remat", mla, 2, 64)
    train_card_vs_cpu("zamba2-1.2b smoke, remat", dataclasses.replace(
        get_smoke_config("zamba2-1.2b"), dtype="float32", remat=True), 2, 64)

    # granite-3-2b at full width and depth
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{LM_ARCH}: remat {cfg.remat}, dtype {cfg.dtype}")
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt, microbatches=LM_TRAIN_MICRO)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms = [], []
    for _ in range(LM_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[lm-train] {LM_ARCH}: losses {losses}")
    want = {"flash_attention": LM_TRAIN_STEPS * LM_TRAIN_MICRO * cfg.n_layers * 2,
            "flash_attention_bwd": LM_TRAIN_STEPS * LM_TRAIN_MICRO * cfg.n_layers}
    check_launches("lm-train", launches, want)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = statistics.median(ms[1:])
    print(f"[lm-train] {LM_ARCH} bf16 full width and depth ({cfg.n_layers} layers, remat), "
          f"AdamW f32 moments, B{LM_TRAIN_BATCH} x S{LM_TRAIN_SEQ} in {LM_TRAIN_MICRO} "
          f"microbatches, "
          f"{LM_TRAIN_STEPS} steps on {card}: losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(x, 1) for x in ms]} (first {ms[0]:.1f}, median of the rest {steady:.1f}, "
          f"host clock to the loss), {tokens / steady * 1e3:.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB; a step launches flash_attention "
          f"{launches['flash_attention'] // LM_TRAIN_STEPS} times and its backward "
          f"{launches['flash_attention_bwd'] // LM_TRAIN_STEPS}; power limit "
          f"{_smi('power.limit')}")
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
    profile_breakdown(f"{LM_ARCH} train step B{LM_TRAIN_BATCH}xS{LM_TRAIN_SEQ}",
                      lambda: step(params, state, batch)[2]["loss"].item(), top=8,
                      also=("fab::",))
    dryrun_train_check(cfg, opt, step, (params, state, batch), steady,
                       torch.cuda.max_memory_allocated(), card)
    del params, state, batch, step
    _free()

    # the smoke config: the reference's loss-descent and resume checks
    smoke = get_smoke_config(LM_ARCH)
    res = train(smoke, steps=12, batch=4, seq=32, lr=3e-3, seed=0, device="cuda")
    if not np.mean(res.losses[-3:]) < np.mean(res.losses[:3]):
        raise AssertionError(f"[lm-train] smoke loss did not fall: {res.losses}")
    full = train(smoke, steps=6, batch=2, seq=16, seed=3, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        train(smoke, steps=3, batch=2, seq=16, seed=3, ckpt_dir=d, ckpt_every=3, device="cuda")
        part2 = train(smoke, steps=6, batch=2, seq=16, seed=3, ckpt_dir=d, ckpt_every=3,
                      device="cuda")
    if part2.resumed_from != 3:
        raise AssertionError(f"[lm-train] resumed from {part2.resumed_from}")
    np.testing.assert_allclose(full.losses[3:], part2.losses, rtol=RESUME_RTOL)
    print(f"[lm-train] {LM_ARCH} smoke bf16: loss over 12 steps "
          f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f} (mean of the last 3 below the "
          f"first 3); 3 steps + checkpoint + restore + 3 == 6 straight steps "
          f"(losses {[round(x, 5) for x in part2.losses]} vs "
          f"{[round(x, 5) for x in full.losses[3:]]}, rtol {RESUME_RTOL:g})")
    return launches


def _leaf_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensors: what the
    caching allocator handed out for them (views counted once, a view's
    whole storage counted)."""
    from torch.utils._pytree import tree_leaves
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(held.values())


def dryrun_train_check(cfg, opt, step, args: tuple, step_ms: float, peak: int,
                       card: str) -> None:
    """[dryrun] on [lm-train]'s model: one more step on the card under
    ``launch.trace_cost``'s counter, against the same step traced on meta
    tensors (``lm.abstract_params``, AdamW's state of them, a batch of the
    same shapes) as launch analysis traces it. The FLOPs must be equal (the
    meta path takes the card's branches), and the predicted argument bytes
    equal to the storages that the card's allocator holds for the same
    state; printed beside them: the meta trace's peak
    (the arguments plus its live bytes) against the phase's measured peak,
    and the trace's compute term at the card's bf16 peak against the
    measured step."""
    from repro_torch.launch import trace_cost
    from repro_torch.models import lm
    t0 = time.perf_counter()
    with trace_cost.TraceCost(args) as on_card:
        out = step(*args)
        torch.cuda.synchronize()
    del out
    _free()
    meta_params = lm.abstract_params(cfg)
    meta = (meta_params, opt.init(meta_params),
            {k: torch.empty_like(v, device="meta") for k, v in args[2].items()})
    with trace_cost.TraceCost(meta) as on_meta:
        step(*meta)
    counts = lambda c: (c.flops, c.product_flops)
    if counts(on_card) != counts(on_meta):
        raise AssertionError(f"[dryrun] FLOPs on the card {counts(on_card)} != the meta "
                             f"trace's {counts(on_meta)}")
    held, predicted = _storage_bytes(args), _leaf_bytes(meta)
    if held != predicted:
        raise AssertionError(f"[dryrun] argument bytes: meta {predicted}, card {held}")
    form, (_, _, bf16_peak, _) = card_peaks(card)
    peak_pred = predicted + on_meta.peak_bytes
    compute_ms = on_meta.flops / bf16_peak * 1e3
    print(f"[dryrun] {LM_ARCH} train step B{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in "
          f"{LM_TRAIN_MICRO} microbatches, remat: FLOPs on the card {on_card.flops:.6e} "
          f"(products {on_card.product_flops:.6e}) == the meta trace's; {on_meta.ops.total()} "
          f"ops traced; argument bytes predicted {predicted} == the storages allocated for "
          f"them {held} "
          f"({held / 1e9:.2f} GB); predicted peak {peak_pred / 1e9:.2f} GB (arguments + "
          f"{on_meta.peak_bytes / 1e9:.2f} GB live) against [lm-train]'s measured "
          f"{peak / 1e9:.2f} GB: ratio {peak_pred / peak:.4f}; compute term "
          f"{compute_ms:.1f} ms at {bf16_peak / 1e12:g} TFLOP/s bf16 ({form}) is "
          f"{100 * compute_ms / step_ms:.1f}% of the measured {step_ms:.1f} ms step; bytes "
          f"term {on_meta.bytes / card_peaks(card)[1][1] * 1e3:.1f} ms; {card}, "
          f"{_smi('power.limit')}; {time.perf_counter() - t0:.1f} s")


def opcheck_cases(shapes: dict) -> dict:
    """Each kernel operator at its main-path shape (PERF.md §6: the
    engine kernels at ``[full]``'s largest operands, the attention kernels
    at granite-3-2b's prefill, backward and decode), as ``torch.library
    .opcheck`` takes them."""
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device="cuda").manual_seed(9)
    ops = torch.ops.repro_torch
    m, k, n, t = shapes["block_matmul"]
    cases = {"block_matmul": (ops.block_matmul.default,
                              (_normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5), t))}
    m, k, n, act = shapes["fused_dense"]
    cases["fused_dense"] = (ops.fused_dense.default,
                            (_normal(gen, (m, k)), _normal(gen, (k, n), k ** -0.5),
                             _normal(gen, (n,)), act))
    n, d, t, depth = shapes["decision_forest"]
    cases["decision_forest"] = (ops.forest_predict.default, _forest_inputs(gen, n, d, t, depth))
    b, hq, hkv, s, d = lm_shapes()["flash_attention"]
    q, k, v = _attn_inputs(gen, b, hq, hkv, s, d, torch.bfloat16)
    o, lse = fa._forward_op(q, k, v, True, True)
    cases["flash_attention"] = (ops.flash_attention.default, (q, k, v, True, True))
    cases["flash_attention_bwd"] = (ops.flash_attention_bwd.default,
                                    (q, k, v, o, lse, torch.randn_like(o), True))
    b, hq, hkv, cap, filled, d = lm_shapes()["flash_decode"]
    kc, vc = (_normal(gen, (b, cap, hkv, d), dtype=torch.bfloat16) for _ in range(2))
    qd = _normal(gen, (b, hq, d), dtype=torch.bfloat16)
    cases["flash_decode"] = (ops.flash_decode.default,
                             (qd, kc, vc, torch.tensor(filled, dtype=torch.int32,
                                                       device="cuda")))
    cases["flash_decode_n"] = (ops.flash_decode_n.default, (qd, kc, vc, filled))
    return cases


def phase_dryrun(shapes: dict) -> None:
    """[dryrun]: ``torch.library.opcheck`` of every kernel operator at its
    main-path shape on the card: the schema, the autograd registration and
    the shape-only (fake) implementation's shapes, dtypes and strides
    against the kernel's (what launch analysis traces on meta tensors).
    The FLOP and memory checks run in ``[lm-train]`` on its model
    (``dryrun_train_check``)."""
    for name, (op, args) in opcheck_cases(shapes).items():
        t0 = time.perf_counter()
        torch.library.opcheck(op, args)
        shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        print(f"[dryrun] opcheck {op} at {shape}: schema, autograd registration, fake "
              f"(shapes, dtypes, strides against the kernel), aot dispatch: OK "
              f"({time.perf_counter() - t0:.1f} s)")
    _free()


BWD_TIME_SHAPES = {  # label -> (B, Hq, Hkv, S, Skv, D, Dv, causal)
    LM_ARCH: BWD_MAIN_SHAPES[LM_ARCH],
    "qwen2-vl-72b": (4, 64, 8, 2048, 2048, 128, 128, True),
    "deepseek-v2 MLA": BWD_MAIN_SHAPES["deepseek-v2 MLA"],
    "seamless cross": BWD_MAIN_SHAPES["seamless cross"],
}
BWD_PARTS = {"Dr": "bwd_preprocess", "dK/dV": "dkdv<", "dQ": "::dq<"}  # profiler names


def device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` takes in each kernel, by the profiler's
    kernel names, over ``calls`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def bwd_split_child() -> None:
    """Prints one JSON line: label -> {part: device ms a call} for the
    backward's kernels (``BWD_PARTS``) at each ``BWD_TIME_SHAPES`` shape."""
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for label, (b, hq, hkv, s, skv, d, dv, causal) in BWD_TIME_SHAPES.items():
        q, k, v, do = _bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, torch.bfloat16)
        o, lse = fa._forward(q, k, v, causal, with_lse=True)
        by_kernel = device_ms_by_kernel(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                       causal))
        out[label] = {part: sum(ms for n, ms in by_kernel.items() if pat in n)
                      for part, pat in BWD_PARTS.items()}
        del q, k, v, do, o, lse
        _free()
    print(json.dumps(out))


def bwd_split_ms() -> dict:
    """``bwd_split_child``'s result, from a child process: late in a whole
    run the profiler has reported no device time for these calls, while a
    fresh process reports them."""
    done = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.bwd_split_child()"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"bwd_split_child failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def _sdpa_bwd(leaves, do, causal):
    """SDPA's backward on a kept graph (its forward not rerun)."""
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                           enable_gqa=True)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def phase_attention_bwd_times(train_launches: dict, errs: dict, card: str) -> dict:
    """10c: the backward at the training shapes of granite-3-2b (the JSON
    row), qwen2-vl (D 128, 64 / 8 heads), MLA ((192, 128) at B 1 x 128
    heads) and seamless's non-causal cross attention (Skv 1000), each
    beside the plain backward and SDPA's backward on a kept graph (the
    default's time, then each backend's where it takes the inputs), with
    the bound from ``ops.bwd_flops`` and the kernels' ms one by one
    (``bwd_split_ms``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain
    gen = torch.Generator(device="cuda").manual_seed(9)
    t = lambda x: x.transpose(1, 2)
    steps = LM_TRAIN_STEPS
    split = bwd_split_ms()
    row = None
    for label, (b, hq, hkv, s, skv, d, dv, causal) in BWD_TIME_SHAPES.items():
        q, k, v, do = _bwd_inputs(gen, b, hq, hkv, s, skv, d, dv, torch.bfloat16)
        o, lse = fa._forward(q, k, v, causal, with_lse=True)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        backends = []
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
            short = name.split("_")[0].lower()
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    one = _sdpa_bwd(leaves, do, causal)
                backends.append(f"{short} {cuda_ms(one):.4f} ms")
                del one
            except RuntimeError:
                backends.append(f"{short} refuses")
        kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        parts = ", ".join(f"{part} {ms:.4f} ms" if ms > 0 else f"{part} not measured"
                          for part, ms in split[label].items())
        calls = (f"; {train_launches['flash_attention_bwd'] // steps} calls a train step "
                 f"({LM_TRAIN_MICRO} microbatches of B {LM_TRAIN_BATCH // LM_TRAIN_MICRO} x "
                 f"40 layers)" if label == LM_ARCH else "")
        got = kernel_row(
            "flash_attention_bwd", kernel,
            lambda: flash_attention_bwd_plain(t(q), t(k), t(v), t(o), t(lse), t(do), causal),
            _sdpa_bwd(leaves, do, causal), fa.bwd_flops(b, hq, s, skv, d, dv, causal),
            # q, k, v, o, do read and dq, dk, dv written (bf16), lse read (f32)
            2.0 * (2 * b * s * hq * d + 2 * b * s * hq * dv + 2 * b * skv * hkv * (d + dv))
            + 4.0 * b * hq * s,
            (label, b, hq, hkv, s, skv, d, dv, "causal" if causal else "non-causal", "bf16"),
            train_launches, errs, card, bf16=True,
            note=lambda ms: (f"; by kernel (profiler in a child process, a call): {parts}; "
                             f"SDPA backward by "
                             f"backend: {', '.join(backends)}{calls}"))
        if label == LM_ARCH:
            row = got
        del q, k, v, do, o, lse, leaves, kernel
        _free()
    return row


# [lm-train-mesh]: training on a (data, model) mesh of gloo ranks sharing cuda:0
# arch, layers kept, (data, model) or (pod, data, model), B, S: one f32 step each
TRAIN_MESH_F32 = (
    ("stablelm-12b", 1, (MESH_RANKS, 1), 4, 128),
    # FSDP over data 2 and tensor parallel over model 2
    ("stablelm-12b", 1, (2, MESH_RANKS // 2), 4, 128),
    ("granite-moe-1b-a400m", 2, (2, MESH_RANKS // 2), 2, 128),  # 256 tokens: none drops
    # rows over pod and data, experts over model
    ("granite-moe-1b-a400m", 2, (2, 1, MESH_RANKS // 2), 2, 128),
    # MLA's heads, its shared experts and 16 of its 160 experts over model 2,
    # FSDP over data 2 (MLA_F32_EXPERTS: [lm-mla]'s f32 cut)
    ("deepseek-v2-236b", 1, (2, MESH_RANKS // 2), 2, 128),
    # the Mamba-2 channels and the shared block over model 2: 2 layers, the
    # shared block after the last
    ("zamba2-1.2b", 2, (2, MESH_RANKS // 2), 4, 128),
    # 2 of xLSTM's 4 mLSTM heads a rank and its gates over model 2: one
    # mLSTM and one sLSTM layer
    ("xlstm-1.3b", 2, (2, MESH_RANKS // 2), 4, 128),
    # the encoder-decoder's heads and FFN over model 2: one encoder and one
    # decoder layer over 128 frames
    ("seamless-m4t-medium", 1, (2, MESH_RANKS // 2), 4, 128),
)
TRAIN_MESH_BF16 = (  # arch, layers kept, (data, model), B, S, microbatches, steps
    # 2 steps each, the first against one device, the second after an update;
    # cut in depth as LM_MESH_STEPS says why
    ("stablelm-12b", 2, (MESH_RANKS, 1), 4, 2048, 1, 2),
    ("stablelm-12b", 2, (2, MESH_RANKS // 2), 4, 2048, 1, 2),  # FSDP and TP
    ("granite-moe-1b-a400m", 6, (2, MESH_RANKS // 2), 4, 2048, 2, 2),
    ("zamba2-1.2b", 6, (2, MESH_RANKS // 2), 4, 2048, 1, 2),  # one shared application
)
TRAIN_MESH_BF16_TOL = 3e-2  # a bf16 rank's first loss against one device's


def _train_mesh_cfg(arch: str, dtype: str, layers: int):
    """A ``[lm-train-mesh]`` config: full width, ``layers`` deep (``_depth``);
    deepseek-v2 in float32 with ``MLA_F32_EXPERTS`` of its experts."""
    cfg = _family_cfg(arch, dtype, **_depth(_family_cfg(arch), layers))
    if cfg.attn == "mla" and dtype == "float32":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               n_experts=MLA_F32_EXPERTS))
    return cfg


def _train_mesh_params(cfg, mesh, rank: int, ways: int) -> tuple:
    """(this rank's placement of ``init_params(cfg, 0)``, the specs): each
    rank draws the whole params and keeps its blocks, one rank at a time."""
    import torch.distributed as dist
    from repro_torch.models import lm, sharding
    specs = sharding.train_specs(cfg, lm.param_shapes(cfg), mesh)
    for r in range(ways):
        if r == rank:
            whole = lm.init_params(cfg, seed=0, device="cuda")
            params = sharding.place(whole, specs, mesh)
            del whole
            _free()
        dist.barrier()
    return params, specs


def _train_batch(cfg, b: int, s: int, steps: int = 1) -> list:
    """``steps`` batches of ``TokenPipeline``'s tokens, with the
    encoder-decoder's frames [b, s, D] from a seeded CPU generator."""
    from repro_torch.data.tokens import TokenPipeline
    pipe = TokenPipeline(vocab=cfg.vocab, batch=b, seq=s, seed=0)
    gen = torch.Generator().manual_seed(9)
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
        if cfg.kind == "encdec":
            batch["enc_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen).cuda()
        out.append(batch)
    return out


def _rank_heads(cfg, mesh) -> tuple:
    """(query heads, KV heads) of this rank's attention: its block of the
    heads where the model splits them over ``model``, else all of them."""
    from repro_torch.models import lm
    hq, _, hkv = lm._local_kv(cfg, lm._tp(cfg, mesh))
    return hq, hkv


def _attn_dims(cfg) -> tuple:
    """(D, Dv) of the model's prefill attention: MLA's (nope + rope, v),
    else (hd, hd)."""
    m = cfg.mla
    return (m.nope_dim + m.rope_dim, m.v_dim) if cfg.attn == "mla" else (cfg.hd, cfg.hd)


def _rank_attention_bwd(cfg, b_loc: int, s: int, rank: int, dtype, tol: float,
                        mesh) -> float:
    """flash_attention's backward at this rank's shape of the layer's
    attention (its rows, its heads), seeded by the rank, against the plain
    backward; outside the counted window."""
    gen = torch.Generator(device="cuda").manual_seed(40 + rank)
    hq, hkv = _rank_heads(cfg, mesh)
    inputs = _bwd_inputs(gen, b_loc, hq, hkv, s, s, *_attn_dims(cfg), dtype)
    err, _ = bwd_vs_plain(inputs, True, tol,
                          f"[lm-train-mesh] rank {rank} {cfg.name} flash_attention backward")
    del inputs
    return err


def _want_launches(cfg, micro: int) -> dict:
    """flash_attention's forward and backward launches of one train step:
    a layer's attention once a microbatch (the encoder-decoder's encoder,
    self- and cross-attention; none in xLSTM), its forward again under
    remat (the hybrid's shared block, outside the reference's scan, is not
    rematerialized)."""
    from repro_torch.models import lm
    if cfg.kind == "hybrid":
        per = lm._n_attn(cfg) * micro
        return {"flash_attention": per, "flash_attention_bwd": per}
    per = mesh_launches(cfg)[0] * micro
    return {"flash_attention": per * (2 if cfg.remat else 1), "flash_attention_bwd": per}


def _blocks_on_first(w, spec: tuple, rank: int):
    """Every rank's block of a leaf under ``spec`` (the training placement)
    on rank 0, as (rank, block) pairs (None on the others): each rank sends
    a host copy of its block to rank 0 alone (a gloo ``gather``). A leaf
    that ``spec`` leaves whole is rank 0's own."""
    import torch.distributed as dist
    from repro_torch.models import sharding
    if not sharding.spec_axes(spec):
        return [(0, w)] if rank == 0 else None
    blk = w.detach().cpu().contiguous()
    blocks = [torch.empty_like(blk) for _ in range(dist.get_world_size())] if rank == 0 else None
    dist.gather(blk, blocks, dst=0)
    return list(enumerate(blocks)) if rank == 0 else None


def _train_mesh_f32(arch, layers, shape, b, s, mesh, rank, ways) -> dict:
    """(a): one f32 step (AdamW lr 1e-2, eps 1e-3) on the mesh against the
    same step on one device, run on rank 0: each rank's loss at
    ``TRAIN_LOSS_TOL``; the updated params, gathered a leaf at a time, at
    ``TRAIN_GRAD_TOL`` of the leaf's largest |update|, and AdamW's moments
    (which hold the gradient itself: mu = 0.1 g, nu = 0.001 g^2) at
    ``TRAIN_GRAD_TOL`` of the leaf's largest |value|; for ``F32_ULP_ARCHS``
    the params' bar (not the moments') at least ``XLSTM_ULPS`` times the
    one-device step's own response to a one-ulp move of the embeddings
    (``_ulp_moved``), as ``lm_mesh_bar`` holds their logits: AdamW's first
    step divides each gradient element by |g| + eps, so an element near eps
    turns a rounding of the gradient into a larger change of the update,
    while the moments hold the gradient itself; the MoE's drops;
    this rank's launches; the backward kernel at the rank's shape. Rank 0
    takes the one-device steps first and keeps their results on the host,
    so that the card never holds them beside the four ranks' mesh state
    (deepseek-v2's did not fit beside it), and holds each rank's block of
    a leaf to the same block of one device's (``sharding.block_view``)."""
    import torch.distributed as dist
    from repro_torch.models import layers as L, lm, sharding
    from repro_torch.train.optim import AdamW
    cfg = _train_mesh_cfg(arch, "float32", layers)
    (batch,) = _train_batch(cfg, b, s)
    opt = AdamW(lr=1e-2, eps=1e-3)
    ref = None
    t0 = time.perf_counter()

    def ratio(blocks, tree, name, spec=()) -> float:
        """max|block - one device's block| over the (rank, block) pairs of a
        leaf under ``spec``, over the whole leaf's largest update (params)
        or |value| (moments); the host's copy comes to the card a leaf at a
        time."""
        want, scale = ref[tree][name].cuda(), ref["scale"][tree][name]
        axes = sharding.spec_axes(spec)
        err = max(float((part.to(want.device)
                         - sharding.block_view(want, spec, mesh, axes, r)).abs().max())
                  for r, part in blocks)
        r = err / max(scale, 1e-30)
        return r if np.isfinite(r) else float("inf")

    if rank == 0:
        one = lm.make_train_step(cfg, opt)
        p0 = lm.init_params(cfg, seed=0, device="cuda")
        p1, s1, m1 = one(p0, opt.init(p0), batch)
        trees = {"params": flat_tree(p1), "mu": flat_tree(s1.mu), "nu": flat_tree(s1.nu)}
        base = flat_tree(p0)
        ref = {t: {k: v.cpu() for k, v in leaves.items()} for t, leaves in trees.items()}
        ref.update(loss=float(m1["loss"]), scale={t: {
            k: float(((v - base[k]) if t == "params" else v).abs().max())
            for k, v in leaves.items()} for t, leaves in trees.items()})
        del p1, s1, trees, base
        ref["response"] = None
        if arch in F32_ULP_ARCHS:
            moved = _ulp_moved(p0, seed=5)
            p1, s1, _ = one(moved, opt.init(moved), batch)
            ref["response"] = max(ratio([(0, v)], "params", k)
                                  for k, v in flat_tree(p1).items())
            del moved, p1, s1
        del p0
        _free()
    t_ref = time.perf_counter() - t0
    params, specs = _train_mesh_params(cfg, mesh, rank, ways)
    step = lm.make_train_step(cfg, opt, mesh=mesh)
    state = opt.init(params)
    torch.cuda.synchronize()
    reset_launches()
    with L.count_drops() as drops:
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
    launched = read_launches()
    n_drops = int(sum(int(d) for d in drops))
    report = {"arch": arch, "mesh": list(shape), "rank": rank, "loss": float(m["loss"]),
              "launches": launched, "want": _want_launches(cfg, 1), "drops": n_drops}
    t_step = time.perf_counter() - t0 - t_ref
    flat_specs = flat_tree(specs)
    worst = {}
    for tree, mine in (("params", params), ("mu", state.mu), ("nu", state.nu)):
        worst[tree] = (0.0, "")
        for name, w in flat_tree(mine).items():
            # rank 0 gathers every rank's block and holds it to one device's
            blocks = _blocks_on_first(w, flat_specs[name], rank)
            if ref is not None:
                worst[tree] = max(worst[tree],
                                  (ratio(blocks, tree, name, flat_specs[name]), name))
            del blocks
    one_device = None if ref is None else {
        "loss": ref["loss"], "worst": worst, "response": ref["response"] is not None,
        "bar": dict(params=max(TRAIN_GRAD_TOL, XLSTM_ULPS * (ref["response"] or 0.0)),
                    mu=TRAIN_GRAD_TOL, nu=TRAIN_GRAD_TOL)}
    del params, state, ref
    _free()
    box = [one_device]
    dist.broadcast_object_list(box, src=0)
    report.update(one_device=box[0], secs=[t_ref, t_step, time.perf_counter() - t0 - t_ref - t_step])
    for tree, (err, name) in box[0]["worst"].items():
        if not err <= box[0]["bar"][tree]:
            raise AssertionError(f"[lm-train-mesh] {arch} {shape}: {tree} leaf {name} max|err| "
                                 f"is {err:.3g} of its largest "
                                 f"{'update' if tree == 'params' else '|value|'} (bar "
                                 f"{box[0]['bar'][tree]:.3g})")
    kernel_vs_plain(torch.tensor(report["loss"]), torch.tensor(box[0]["loss"]),
                    TRAIN_LOSS_TOL, f"[lm-train-mesh] rank {rank} {arch} f32 loss")
    rows = sharding.batch_rows(mesh, b)
    b_loc = b if rows is None else rows.stop - rows.start
    report["bwd"] = None if cfg.kind == "xlstm" else {
        "shape": [b_loc, *_rank_heads(cfg, mesh), s, *_attn_dims(cfg)],
        "err": _rank_attention_bwd(cfg, b_loc, s, rank, torch.float32, ATTN_TOL, mesh)}
    return report


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flat_tree(tree).values())


def _train_mesh_bf16(arch, layers, shape, b, s, micro, steps, mesh, rank, ways) -> dict:
    """(b), (c): ``steps`` bf16 steps (AdamW lr 3e-4, f32 moments) on the
    mesh: losses, host ms a step to the loss, this rank's peak memory and
    state bytes beside the whole state's, its launches."""
    from repro_torch.models import lm
    from repro_torch.train.optim import AdamW
    cfg = _train_mesh_cfg(arch, "bfloat16", layers)
    params, _ = _train_mesh_params(cfg, mesh, rank, ways)
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    local = _tree_bytes(params) + _tree_bytes(state.mu) + _tree_bytes(state.nu)
    whole = sum(int(np.prod(sh)) for sh in flat_tree(lm.param_shapes(cfg)).values())
    step = lm.make_train_step(cfg, opt, microbatches=micro, mesh=mesh)
    batches = _train_batch(cfg, b, s, steps)
    torch.cuda.synchronize()
    reset_launches()
    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = read_launches()
    report = {"arch": arch, "layers": layers, "mesh": list(shape), "rank": rank,
              "losses": losses, "ms": ms, "launches": launched,
              "want": {k: v * steps for k, v in _want_launches(cfg, micro).items()},
              "state_bytes": local, "whole_state_bytes": whole * (2 + 4 + 4),
              "peak_bytes": torch.cuda.max_memory_allocated()}
    rows = b // micro // shape[0] if (b // micro) % shape[0] == 0 else b // micro
    report["bwd"] = {"shape": [rows, *_rank_heads(cfg, mesh), s, *_attn_dims(cfg)],
                     "err": _rank_attention_bwd(cfg, rows, s, rank, torch.bfloat16,
                                                BF16_TOL, mesh)}
    del params, state, step, batches
    _free()
    return report


def train_mesh_rank(rank: int, ways: int, out_dir: str) -> None:
    """One rank of [lm-train-mesh]: the f32 checks, then the bf16 runs;
    writes its reports to ``out_dir/train-rank{rank}.json``."""
    from repro_torch.testing import host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = host_mesh(shape, device="cuda")
        return meshes[shape]

    reports = [_train_mesh_f32(*c, mesh_of(c[2]), rank, ways) for c in TRAIN_MESH_F32]
    reports += [_train_mesh_bf16(*c, mesh_of(c[2]), rank, ways) for c in TRAIN_MESH_BF16]
    Path(out_dir, f"train-rank{rank}.json").write_text(json.dumps(reports))


def phase_lm_train_mesh(card: str) -> None:
    """[lm-train-mesh]: ``make_train_step(mesh=)`` on ``MESH_RANKS`` gloo ranks
    time-slicing cuda:0 (``train_mesh_rank``). (a) f32 at full width, cut
    in depth: stablelm-12b (FSDP over data 4; head dim 160, the backward's
    (160, 160) pair in two passes; and on 2 x 2, FSDP over data and tensor
    parallel over model), granite-moe (experts over model 2, no token
    dropped), deepseek-v2 (1 layer with ``MLA_F32_EXPERTS`` of its 160
    experts on 2 x 2: FSDP over data, MLA's heads, shared experts and
    experts over model; the backward at MLA's (192, 128) pair), zamba2 (2
    layers on 2 x 2: the Mamba-2 channels and the shared block over
    model), xlstm-1.3b (one mLSTM and one sLSTM layer on 2 x 2: 2 of 4
    heads a rank, the gates gathered at use) and seamless-m4t-medium (one
    encoder and one decoder layer on 2 x 2, 128 frames), each rank against
    one device. (b) stablelm-12b in bf16 at full
    width (2 of 40 layers), B 4 x 2048, FSDP over 4 data ranks and on 2 x 2
    (FSDP and tensor parallel); (c) granite-moe (6 of 24 layers) and zamba2
    (6 of 38) in bf16 on 2 x 2. Each rank's
    flash_attention forward and backward launches must match its layers
    and microbatches; each rank holds the backward kernel at its own shape
    (its rows and heads) against the plain backward. The one-device loss
    of (b)'s first batch comes from this process, and both meshes' first
    losses are held to it. Times are of ranks sharing one card and its
    host: no multi-card speed."""
    import tempfile
    from repro_torch.models import lm
    from repro_torch.testing import mesh_tag, spawn_ranks
    _free()
    arch, layers, shape, b, s, micro, steps = TRAIN_MESH_BF16[0]
    cfg = _family_cfg(arch, n_layers=layers)
    params = lm.init_params(cfg, seed=0, device="cuda")
    with torch.no_grad():
        want = float(lm.loss_fn(params, cfg, _train_batch(cfg, b, s)[0]))
    del params
    _free()
    # the ranks share the card's 80 GB: segments that grow, so that the
    # step's changing sizes do not strand memory between them
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            spawn_ranks(train_mesh_rank, MESH_RANKS, args=(out,), device="cuda:0",
                        timeout_s=MESH_TIMEOUT_S)
            secs = time.perf_counter() - t0
            reports = [json.loads(Path(out, f"train-rank{r}.json").read_text())
                       for r in range(MESH_RANKS)]
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    limit = _smi("power.limit")
    for i, (arch, layers, shape, b, s) in enumerate(TRAIN_MESH_F32):
        for r in range(MESH_RANKS):
            rep = reports[r][i]
            got = {k: rep["launches"][k] for k in rep["want"]}
            if got != rep["want"] or rep["drops"]:
                raise AssertionError(f"[lm-train-mesh] {arch} rank {r}: launches {got}, want "
                                     f"{rep['want']}; {rep['drops']} tokens dropped")
            one = rep["one_device"]
            cut = _train_mesh_cfg(arch, "float32", layers)
            experts = (f" and {cut.moe.n_experts} of {_family_cfg(arch).moe.n_experts} experts"
                       if cut.moe else "")
            print(f"[lm-train-mesh] {arch} f32 full width, {layers} layer(s){experts}, mesh "
                  f"{mesh_tag(shape)} rank {r}, B{b} x S{s}, one step (AdamW lr 1e-2, eps "
                  f"1e-3): loss {rep['loss']:.6f} vs one device {one['loss']:.6f} (bar "
                  f"{TRAIN_LOSS_TOL:g}); gathered leaves, worst max|err| / the leaf's largest "
                  f"update (params) or |value| (moments): params "
                  f"{one['worst']['params'][0]:.3g} ({one['worst']['params'][1]}), mu "
                  f"{one['worst']['mu'][0]:.3g}, nu {one['worst']['nu'][0]:.3g} (bars "
                  f"{', '.join(f'{t} {b:.3g}' for t, b in one['bar'].items())}"
                  + (f"; params' {TRAIN_GRAD_TOL:g} or {XLSTM_ULPS}x the one-device step's "
                     f"one-ulp response" if one["response"] else "") + "); "
                  f"{rep['drops']} tokens dropped; launches {json.dumps(got)}; "
                  + ("no attention kernel; " if rep["bwd"] is None else
                     f"flash_attention backward at the rank's shape (B, Hq, Hkv, S, D, Dv) = "
                     f"{rep['bwd']['shape']} == plain, max|err|={rep['bwd']['err']:.3g} (bar "
                     f"{ATTN_TOL:g}); ")
                  + f"seconds: one "
                  f"device's steps {rep['secs'][0]:.1f}, the mesh's params and step "
                  f"{rep['secs'][1]:.1f}, the gathers {rep['secs'][2]:.1f}; {card}, {limit}")
    n_f32 = len(TRAIN_MESH_F32)
    for i, (arch, layers, shape, b, s, micro, steps) in enumerate(TRAIN_MESH_BF16):
        reps = [reports[r][n_f32 + i] for r in range(MESH_RANKS)]
        losses = reps[0]["losses"]
        if not all(np.isfinite(losses)) or any(rep["losses"] != losses for rep in reps):
            raise AssertionError(f"[lm-train-mesh] {arch} bf16 losses "
                                 f"{[rep['losses'] for rep in reps]}")
        first = ""
        if (arch, layers, b, s) == TRAIN_MESH_BF16[0][:2] + TRAIN_MESH_BF16[0][3:5]:
            kernel_vs_plain(torch.tensor(losses[0]), torch.tensor(want), TRAIN_MESH_BF16_TOL,
                            f"[lm-train-mesh] {arch} {mesh_tag(shape)} bf16 first loss")
            first = (f"; the first loss {losses[0]:.6f} vs one device {want:.6f} (bar "
                     f"{TRAIN_MESH_BF16_TOL:g})")
        full = _family_cfg(arch)
        for r, rep in enumerate(reps):
            got = {k: rep["launches"][k] for k in rep["want"]}
            if got != rep["want"]:
                raise AssertionError(f"[lm-train-mesh] {arch} bf16 rank {r}: launches {got}, "
                                     f"want {rep['want']}")
            ms = rep["ms"]
            print(f"[lm-train-mesh] {arch} bf16 full width, {layers} of {full.n_layers} layers "
                  f"(remat {full.remat}, FSDP {full.fsdp}), mesh {mesh_tag(shape)} rank {r}, "
                  f"B{b} x S{s} in {micro} microbatch(es), {steps} steps (AdamW lr 3e-4, f32 "
                  f"moments): losses {[round(x, 5) for x in rep['losses']]} (equal on all "
                  f"ranks){first}; step ms {[round(x, 1) for x in ms]} (host clock to the "
                  f"loss; median of the last {steps - 1}: {statistics.median(ms[1:]):.1f}); "
                  f"peak {rep['peak_bytes'] / 1e9:.2f} GB; state a rank {rep['state_bytes'] / 1e9:.2f}"
                  f" GB of the whole {rep['whole_state_bytes'] / 1e9:.2f} GB (bf16 params, f32 "
                  f"moments); a step launches flash_attention "
                  f"{got['flash_attention'] // steps} and its backward "
                  f"{got['flash_attention_bwd'] // steps}; backward at the rank's shape "
                  f"{rep['bwd']['shape']} == plain, max|err|={rep['bwd']['err']:.3g} (bar "
                  f"{BF16_TOL:g}); {card}, {limit}")
    print(f"[lm-train-mesh] {MESH_RANKS} gloo ranks time-slicing cuda:0 (not a multi-card "
          f"speed): {secs:.1f} s, spawn included")


def timed(phase):
    """``phase`` with its wall seconds printed after it (``[phase]`` line)."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        out = phase(*a, **kw)
        print(f"[phase] {phase.__name__} {time.perf_counter() - t0:.1f} s")
        return out
    return run


def main() -> int:
    card = phase_device()
    timed(phase_build)()
    timed(phase_parity)()
    errs = timed(phase_attention_parity)(lm_shapes())
    errs.update(timed(phase_attention_bwd_parity)())
    launches, refs = timed(phase_main_path)()
    profile = timed(phase_lower)()
    timed(phase_plan)(profile, refs)
    shapes = timed(phase_full_size)(profile)
    errs.update(timed(phase_main_shape_parity)(shapes))
    timed(phase_embed)()
    timed(phase_reusable)(profile, timed(phase_train)(profile))
    timed(phase_cache)()
    server, cache = timed(phase_serving)()
    timed(phase_feedback)(server, cache)
    del server, cache
    torch.cuda.empty_cache()
    timed(phase_mesh)()
    timed(phase_lm_mesh)()
    timed(phase_lm_f32)()
    torch.cuda.empty_cache()
    lm_launches, cache = timed(phase_lm_bf16)()
    rows = timed(phase_kernel_times)(shapes, launches, errs, card)
    rows += timed(phase_attention_times)(lm_shapes(), lm_launches, errs, card, cache)
    del cache
    _free()
    timed(phase_family_attention)()
    timed(phase_lm_moe)()
    timed(phase_lm_mrope)()
    timed(phase_lm_encdec)()
    timed(phase_mla_attention)()
    timed(phase_lm_mla)()
    timed(phase_lm_hybrid)()
    timed(phase_lm_xlstm)()
    train_launches = timed(phase_lm_train)(card)
    timed(phase_dryrun)(shapes)
    rows.append(timed(phase_attention_bwd_times)(train_launches, errs, card))
    timed(phase_lm_train_mesh)(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
