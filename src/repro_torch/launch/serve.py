"""Serving launcher: batched request loop over the decode step.

``python -m repro_torch.launch.serve --arch granite-3-2b`` serves the full
config on the card with a synthetic request stream (any ported arch:
granite-moe-1b-a400m, qwen2-vl-72b and seamless-m4t-medium too);
``--smoke --device cpu`` serves the reduced config on the CPU. Ported from
``repro.launch.serve``, with its semantics as they are: one cache ``len``
shared by all slots, prompts teacher-forced token by token through the
decode step, and for the encoder-decoder an empty encoder memory.

The reference's server jits its decode step. Here, on the card, the server
captures its step into one CUDA graph at its first step and replays it on
every step after (``core.plan_cache.CapturedGraph``); the graph advances
the cache's ``len`` in place and picks the greedy tokens itself, so the
host sends [B] tokens and reads [B] back. A capture that fails raises. On
the CPU the same step runs eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.plan_cache import CapturedGraph
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Batched greedy-decode server with a fixed batch of slots. ``params``
    defaults to ``lm.init_params(cfg, seed)`` on ``device`` (the card
    unless the caller names one).

    ``cache`` is the server's own. A caller may set it (a prefilled
    prompt's cache, of the server's batch and ``max_len``) before the first
    step, whose capture holds the tensors it finds; setting it after the
    capture raises at the next step. ``captured`` is the decode
    step's graph on the card (its ``warmup_s``, ``capture_s`` and
    ``pool_bytes``), ``captures`` how many times it was captured, and
    ``logits`` the last step's [B, V] logits (overwritten by the next)."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int,
                 seed: int = 0, device=None, params=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else lm.init_params(cfg, seed, device=self.device))
        self.decode_fn = lm.make_decode_step(cfg)
        self.cache = lm.init_cache(cfg, batch, max_len, device=self.device)
        self.captured: Optional[CapturedGraph] = None
        self.captures = 0
        self.logits: Optional[torch.Tensor] = None
        self.active: List[Optional[Request]] = [None] * batch
        self.tokens = np.zeros((batch,), np.int32)
        self.free_slots = batch

    def admit(self, req: Request) -> bool:
        if self.free_slots == 0:
            return False
        for i, slot in enumerate(self.active):
            if slot is None:
                self.active[i] = req
                # the prompt is processed token by token (one cache len
                # shared by all slots, as in the JAX package)
                self.tokens[i] = int(req.prompt[0])
                self.free_slots -= 1
                return True
        return False

    def _step_body(self, tokens: torch.Tensor):
        """One decode step that advances the cache's own ``len`` in place
        (a graph replays the tensors it captured) and returns (next greedy
        tokens [B] int32, logits)."""
        logits, cache = self.decode_fn(self.params, self.cache, tokens)
        self.cache["len"].copy_(cache["len"])
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _capture(self, tokens: torch.Tensor) -> None:
        # the warm-up runs the step once eagerly and advances len; put it
        # back. The K/V row it wrote is in slot min(len, max_len - 1), which
        # the first replay writes again.
        len0 = self.cache["len"].clone()
        try:
            self.captured = CapturedGraph(self._step_body, tokens, self.device)
        finally:
            self.cache["len"].copy_(len0)
        self.captures += 1
        self._captured_cache = dict(self.cache)

    def decode(self, tokens) -> torch.Tensor:
        """One decode step of the whole batch on ``tokens`` [B]: writes their
        K/V rows, advances ``len`` by one and returns the next greedy tokens
        [B] int32 on the server's device. On the card this is one replay of
        the captured step (captured at the first call)."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32)
        if self.device.type != "cuda":
            nxt, self.logits = self._step_body(tokens.to(self.device))
            return nxt
        if self.captured is None:
            self._capture(tokens.to(self.device))
        elif any(self.cache.get(k) is not v for k, v in self._captured_cache.items()):
            raise RuntimeError("Server: the cache was replaced after the decode "
                               "step was captured; the graph holds the old one")
        nxt, self.logits = self.captured.replay(tokens)
        return nxt

    def step(self) -> int:
        nxt = self.decode(torch.from_numpy(self.tokens)).cpu().numpy()
        done = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            pos = len(req.out)
            if pos + 1 < len(req.prompt):
                self.tokens[i] = int(req.prompt[pos + 1])  # teacher-forced
                req.out.append(int(nxt[i]))
            elif len(req.out) < len(req.prompt) + req.max_new:
                self.tokens[i] = int(nxt[i])
                req.out.append(int(nxt[i]))
            else:
                req.done = True
                self.active[i] = None
                self.free_slots += 1
                done += 1
        return done


def max_decode_steps(requests: List[Request]) -> int:
    """Upper bound on decode steps to serve ``requests``: while any request
    is pending or active, every step advances at least one active request by
    one token, and each request occupies at most prompt+max_new+1 steps
    (the +1 is the retirement step)."""
    return sum(len(r.prompt) + r.max_new + 1 for r in requests) + 1


def synthetic_requests(cfg: ModelConfig, n: int, max_new: int,
                       seed: int = 0) -> List[Request]:
    """``main``'s request stream: prompts of 4-11 random tokens."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 12)),
                    max_new=max_new)
            for i in range(n)]


def serve(server: Server, requests: List[Request]) -> int:
    """Admits and steps until every request is done; returns the steps."""
    pending = list(requests)
    finished = steps = 0
    step_bound = max_decode_steps(pending)
    while finished < len(requests):
        # only touch the admission path when a slot is actually free; a
        # refused request stays at the head of the queue
        while pending and server.free_slots > 0:
            if not server.admit(pending[0]):
                break
            pending.pop(0)
        finished += server.step()
        steps += 1
        if steps > step_bound:
            raise RuntimeError(
                f"serve loop did not converge in {step_bound} steps")
    return steps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    server = Server(cfg, batch=args.batch, max_len=256, device=args.device)
    requests = synthetic_requests(cfg, args.requests, args.max_new)
    t0 = time.perf_counter()
    steps = serve(server, requests)
    dt = time.perf_counter() - t0
    how = (f"one captured graph, captured in {server.captured.capture_s:.2f}s"
           if server.captured is not None else "eager")
    print(f"served {args.requests} requests in {dt:.2f}s "
          f"({steps} decode steps, {args.requests * args.max_new / dt:.1f} tok/s; "
          f"decode step {how})")


if __name__ == "__main__":
    main()
