"""The LM server's captured decode step, on the card.

``launch.serve.Server`` captures its decode step into one CUDA graph at its
first step and replays it after, as the reference's server jits it. A
graph has no CPU mode, so every test here is marked ``cuda`` and skips
without a CUDA card. This file imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py

The captured step gives the eager ``make_decode_step``'s greedy tokens
over 40 steps, its logits within the bf16 bar (3e-2), for the smoke
configs of granite-3-2b, granite-moe-1b-a400m, qwen2-vl-72b and
seamless-m4t-medium (over its empty encoder memory) and for granite-moe
at full width cut to 2 layers; a server captures once, and refuses a
cache set after its capture; each replay
advances ``len`` by one and writes its K/V row where the eager step does,
past ``max_len`` too; two replays of the MoE step on the same state are
bit-equal; a capture that fails raises, with no eager fallback.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import lm

BF16_TOL = 3e-2
STEPS = 40
SMOKE = ("granite-3-2b", "granite-moe-1b-a400m", "qwen2-vl-72b", "seamless-m4t-medium")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a captured decode step has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(name):
    if name == "granite-moe-1b-a400m@2":  # full width, depth cut to 2 layers
        return dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    return get_smoke_config(name)


def _state(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMOKE + ("granite-moe-1b-a400m@2",))
def test_captured_step_matches_eager(cuda_device, name):
    cfg = _cfg(name)
    server = serve.Server(cfg, batch=4, max_len=64, device=cuda_device, seed=1)
    cache = _state(server.cache)
    step = lm.make_decode_step(cfg)
    tok = torch.arange(4, dtype=torch.int32, device=cuda_device) + 5
    for i in range(STEPS):
        logits, cache = step(server.params, cache, tok)
        want = logits.argmax(-1).to(torch.int32)
        got = server.decode(tok)
        assert torch.equal(got, want), f"{name} step {i}: {got} != {want}"
        torch.testing.assert_close(server.logits, logits, rtol=BF16_TOL, atol=BF16_TOL)
        assert int(server.cache["len"]) == int(cache["len"]) == i + 1
        tok = want
    assert server.captures == 1 and server.captured.pool_bytes > 0
    assert bool(server.logits[:, :cfg.vocab].isfinite().all())


@pytest.mark.cuda
def test_server_captures_once(cuda_device):
    cfg = get_smoke_config("granite-moe-1b-a400m")
    server = serve.Server(cfg, batch=4, max_len=128, device=cuda_device)
    requests = serve.synthetic_requests(cfg, 9, 6)
    steps = serve.serve(server, requests)
    assert server.captures == 1 and steps > 9
    assert int(server.cache["len"]) == steps
    assert all(r.done and len(r.out) == len(r.prompt) + r.max_new for r in requests)
    server.cache = _state(server.cache)  # the graph holds the old tensors
    with pytest.raises(RuntimeError, match="replaced"):
        server.decode(np.zeros(4, np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "seamless-m4t-medium"])
def test_len_advances_per_replay_and_clamps(cuda_device, name):
    """max_len 6, 9 steps: each replay writes slot min(len, 5), as the
    eager step does (``test_decode_past_max_len_clamps_like_jax``)."""
    cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    server = serve.Server(cfg, batch=2, max_len=6, device=cuda_device, seed=3)
    cache = _state(server.cache)
    step = lm.make_decode_step(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for i in range(9):
        tok = torch.randint(0, cfg.vocab, (2,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
        _, cache = step(server.params, cache, tok)
        server.decode(tok)
        assert int(server.cache["len"]) == i + 1
        slot = min(i, 5)
        for n in ("k", "v"):
            torch.testing.assert_close(server.cache[n], cache[n], rtol=1e-5, atol=1e-5)
            assert bool(server.cache[n][:, :, slot].abs().sum(-1).gt(0).all())
    assert server.captures == 1


@pytest.mark.cuda
def test_moe_replays_bit_equal(cuda_device):
    """The MoE's combine adds each token's contributions in a fixed order
    (no atomics): two replays from the same state give the same bits."""
    cfg = _cfg("granite-moe-1b-a400m@2")
    server = serve.Server(cfg, batch=4, max_len=32, device=cuda_device, seed=2)
    tok = torch.tensor([1, 7, 7, 300], dtype=torch.int32, device=cuda_device)
    for _ in range(3):
        server.decode(tok)
    before = _state(server.cache)
    outs = []
    for _ in range(2):
        for k, v in before.items():
            server.cache[k].copy_(v)
        nxt = server.decode(tok).clone()
        outs.append((nxt, server.logits.clone(), server.cache["k"].clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_capture_that_fails_raises(cuda_device):
    """A step that reads a value back to the host runs eagerly but cannot
    be captured: the server raises, does not fall back to the eager step,
    and leaves ``len`` as it was."""
    cfg = get_smoke_config("granite-3-2b")
    server = serve.Server(cfg, batch=2, max_len=16, device=cuda_device)
    eager = server.decode_fn

    def host_read(params, cache, token):
        logits, cache = eager(params, cache, token)
        return logits * float(logits[0, 0]), cache

    server.decode_fn = host_read
    with pytest.raises(RuntimeError):
        server.decode(np.array([1, 2], np.int32))
    assert server.captured is None and server.captures == 0
    assert int(server.cache["len"]) == 0
    torch.cuda.synchronize()
