#!/usr/bin/env python3
"""An LM's bf16 prefill and decode step in two checkouts, on one card.

    python3 scripts/decode_ab.py --other DIR [--arch zamba2-1.2b]

``DIR`` is another checkout of this repo (for example the parent commit,
unpacked with ``git archive``). Each turn runs in a process of its own,
in the order other, this, this, other, and uses that checkout's
``chip_smoke.py``: its ``[lm]`` set-up (B 4, a 2048-token prompt, max_len
4096, weights from seed 0; for another ``--arch`` than granite-3-2b, the
full config of its family phase, ``_family_cfg``, at the family shapes)
and its ``time_decode`` (medians of 5 runs of 32
steps, CUDA events), eager (``lm.make_decode_step``) and captured (a
``Server``'s CUDA-graph replay), after the captured tokens are held equal
to the eager ones; also the host's time to enqueue one prefill and the
calls in it that wait for the device (``torch.cuda.set_sync_debug_mode``),
and the host's time by operator in one more prefill (``torch.profiler``,
the CPU only): the operators' count, their summed self time, the time
inside the port's custom operators (``repro_torch::``) and the six
operators of most self time. ``--rounds N`` runs the four turns N times. Prints each turn's line and a
JSON summary beside the card's name and power limit, then for the prefill's
times and the captured step each side's median and quartiles and the pairs
(turn k of each side; the order alternates which side runs first) in
which this checkout reads lower. Exits non-zero without CUDA or if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def turn(root: Path, arch: str) -> dict:
    """One checkout's prefill ms and eager and captured ms a decode step."""
    sys.path.insert(0, str(root))
    import chip_smoke as C
    import torch
    from repro_torch.models import lm
    C.phase_device()
    if arch == C.LM_ARCH:
        cfg, (b, s, max_len) = C._lm_cfg("bfloat16"), (C.LM_BATCH, C.LM_PROMPT, C.LM_MAX_LEN)
    else:
        cfg = C._family_cfg(arch)
        b, s, max_len = C.FAMILY_BATCH, C.FAMILY_PROMPT, C.FAMILY_MAX_LEN
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = C._prompt(gen, cfg, b, s)
    logits, cache = lm.prefill(params, cfg, prompt, max_len=max_len)
    tok0 = logits.argmax(-1)
    prefill_ms = C.median_run_ms(lambda: lm.prefill(params, cfg, prompt, max_len))
    # the host's share: the time to enqueue one prefill, and the calls in
    # it that wait for the device (torch's sync debug mode warns on each)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        lm.prefill(params, cfg, prompt, max_len)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lm.prefill(params, cfg, prompt, max_len)
    torch.cuda.synchronize()
    ops = prof.key_averages()
    host = {"prefill_host_ops": sum(e.count for e in ops),
            "prefill_host_self_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "prefill_custom_op_ms": sum(e.cpu_time_total for e in ops
                                        if e.key.startswith("repro_torch::")) / 1e3,
            "prefill_host_top": [[e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)]
                                 for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]]}
    server, err = C.decode_eager_vs_captured(arch, cfg, params, cache, tok0, max_len)
    eager_ms, graph_ms = C.time_decode(arch, cfg, params, cache, tok0, server, err)
    return {"prefill_ms": prefill_ms, "prefill_enqueue_ms": enqueue_ms,
            "prefill_syncs": sum("synchroniz" in str(w.message) for w in syncs),
            **host, "eager_ms": eager_ms, "captured_ms": graph_ms}


def paired(results: dict, key: str) -> dict:
    """Each side's median and quartiles of ``key``, and the pairs in which
    this checkout reads lower (ties count for neither)."""
    out = {}
    for side, runs in results.items():
        xs = [r[key] for r in runs]
        q1, _, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3
        out[side] = {"median": statistics.median(xs), "q1": q1, "q3": q3}
    pairs = list(zip(results["other"], results["this"]))
    out["this_lower"] = sum(t[key] < o[key] for o, t in pairs)
    out["other_lower"] = sum(o[key] < t[key] for o, t in pairs)
    out["pairs"] = len(pairs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the four turns")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print("TURN " + json.dumps(turn(args.turn.resolve(), args.arch)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: CUDA is not available")
    other = args.other.resolve()
    results: dict = {"other": [], "this": []}
    order = (("other", other), ("this", HERE), ("this", HERE), ("other", other))
    for name, root in order * args.rounds:
        out = subprocess.run([sys.executable, __file__, "--turn", str(root), "--arch",
                              args.arch],
                             capture_output=True, text=True, timeout=600)
        print(f"--- {name} ({root})\n{out.stdout}{out.stderr[-4000:]}", flush=True)
        if out.returncode != 0:
            raise SystemExit(f"decode_ab: the {name} turn exited {out.returncode}")
        line = [x for x in out.stdout.splitlines() if x.startswith("TURN ")][-1]
        results[name].append(json.loads(line[5:]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[decode-ab] {args.arch}, {card.strip()}: " + json.dumps(results))
    for key in ("prefill_ms", "prefill_enqueue_ms", "prefill_host_self_ms", "captured_ms"):
        print(f"[decode-ab] {key}: " + json.dumps(paired(results, key)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
