#!/usr/bin/env python3
"""granite-3-2b's bf16 prefill and decode step in two checkouts, on one card.

    python3 scripts/decode_ab.py --other DIR

``DIR`` is another checkout of this repo (for example the parent commit,
unpacked with ``git archive``). Each turn runs in a process of its own,
in the order other, this, this, other, and uses that checkout's
``chip_smoke.py``: its ``[lm]`` set-up (B 4, a 2048-token prompt, max_len
4096, weights from seed 0) and its ``time_decode`` (medians of 5 runs of 32
steps, CUDA events), eager (``lm.make_decode_step``) and captured (a
``Server``'s CUDA-graph replay), after the captured tokens are held equal
to the eager ones. Prints each turn's line and a JSON summary beside the
card's name and power limit. Exits non-zero without CUDA or if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def turn(root: Path) -> dict:
    """One checkout's prefill ms and eager and captured ms a decode step."""
    sys.path.insert(0, str(root))
    import chip_smoke as C
    import torch
    from repro_torch.models import lm
    C.phase_device()
    cfg = C._lm_cfg("bfloat16")
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = C._prompt(gen, cfg, C.LM_BATCH, C.LM_PROMPT)
    logits, cache = lm.prefill(params, cfg, prompt, max_len=C.LM_MAX_LEN)
    tok0 = logits.argmax(-1)
    prefill_ms = C.median_run_ms(lambda: lm.prefill(params, cfg, prompt, C.LM_MAX_LEN))
    server, err = C.decode_eager_vs_captured(C.LM_ARCH, cfg, params, cache, tok0, C.LM_MAX_LEN)
    eager_ms, graph_ms = C.time_decode(C.LM_ARCH, cfg, params, cache, tok0, server, err)
    return {"prefill_ms": prefill_ms, "eager_ms": eager_ms, "captured_ms": graph_ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print("TURN " + json.dumps(turn(args.turn.resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: CUDA is not available")
    other = args.other.resolve()
    results: dict = {"other": [], "this": []}
    for name, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--turn", str(root)],
                             capture_output=True, text=True, timeout=600)
        print(f"--- {name} ({root})\n{out.stdout}{out.stderr[-4000:]}", flush=True)
        if out.returncode != 0:
            raise SystemExit(f"decode_ab: the {name} turn exited {out.returncode}")
        line = [x for x in out.stdout.splitlines() if x.startswith("TURN ")][-1]
        results[name].append(json.loads(line[5:]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[decode-ab] {card.strip()}: " + json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
