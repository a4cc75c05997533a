"""The LM server's captured decode step, on the card.

``launch.serve.Server`` captures its decode step into one CUDA graph at its
first step and replays it after, as the reference's server jits it. A
graph has no CPU mode, so every test here is marked ``cuda`` and skips
without a CUDA card. This file imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_cuda.py

The captured step gives the eager ``make_decode_step``'s greedy tokens
over 40 steps, its logits within the bf16 bar (3e-2), for the smoke
configs of granite-3-2b, granite-moe-1b-a400m, qwen2-vl-72b,
seamless-m4t-medium (over its empty encoder memory), zamba2-1.2b and
xlstm-1.3b, for deepseek-v2-236b's smoke config with MLA widths that the
flash_attention kernel instantiates (nope 48 + rope 16 against v 32: the
(64, 32) pair; the smoke config's 24 / 16 has no instance) and for
granite-moe at full width cut to 2 layers; the three newest families also
run forward, prefill and three decode steps in float32 on the card and on
the CPU, equal at 1e-4; a server captures once, and refuses a cache set
after its capture, and its capture leaves the cache's states as it found
them; each replay
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
CARD_CPU_TOL = 1e-4
STEPS = 40
SMOKE = ("granite-3-2b", "granite-moe-1b-a400m", "qwen2-vl-72b", "seamless-m4t-medium",
         "zamba2-1.2b", "xlstm-1.3b")
MLA_CARD = "deepseek-v2-236b@64/32"  # the smoke config at a kernel's (D, Dv) pair


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a captured decode step has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(name):
    if name == "granite-moe-1b-a400m@2":  # full width, depth cut to 2 layers
        return dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    if name == MLA_CARD:
        cfg = get_smoke_config("deepseek-v2-236b")
        return dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_dim=48, rope_dim=16, v_dim=32))
    return get_smoke_config(name)


def _state(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMOKE + (MLA_CARD, "granite-moe-1b-a400m@2"))
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


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [MLA_CARD, "zamba2-1.2b", "xlstm-1.3b"])
def test_card_matches_cpu_f32(cuda_device, name):
    """The same float32 weights on the card (the kernels) and on the CPU (the
    plain versions): hidden states, prefill logits and caches, and three
    decode steps' logits and caches within 1e-4."""
    cfg = dataclasses.replace(_cfg(name), dtype="float32")
    params = lm.init_params(cfg, seed=4, device="cpu")
    card = _to(params, cuda_device)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen)

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=CARD_CPU_TOL, atol=CARD_CPU_TOL)

    close(lm.forward(card, cfg, toks.to(cuda_device)), lm.forward(params, cfg, toks))
    lc, cc = lm.prefill(card, cfg, toks[:, :-1].to(cuda_device), max_len=48)
    lh, ch = lm.prefill(params, cfg, toks[:, :-1], max_len=48)
    close(lc, lh)
    step = lm.make_decode_step(cfg)
    tok = toks[:, -1]
    for _ in range(3):
        for k in ch:
            close(cc[k], ch[k])
        lc, cc = step(card, cc, tok.to(cuda_device))
        lh, ch = step(params, ch, tok)
        close(lc, lh)
        tok = lh.argmax(-1)


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
@pytest.mark.parametrize("name", ["granite-3-2b", "seamless-m4t-medium", "zamba2-1.2b"])
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
        for n in ("k", "v"):  # zamba2's: one K/V per shared-block application
            torch.testing.assert_close(server.cache[n], cache[n], rtol=1e-5, atol=1e-5)
            assert bool(server.cache[n][:, :, slot].abs().sum(-1).gt(0).all())
    assert server.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-1.3b"])
def test_capture_leaves_the_states(cuda_device, name):
    """The capture's warm-up runs the step once; the recurrent states it
    overwrote are put back, so the first replay starts from the cache the
    server had (a prefilled one here)."""
    cfg = _cfg(name)
    server = serve.Server(cfg, batch=2, max_len=32, device=cuda_device, seed=5)
    _, server.cache = lm.prefill(server.params, cfg,
                                 torch.tensor([[3, 9, 4], [7, 1, 2]], device=cuda_device), 32)
    before = _state(server.cache)
    server._capture(torch.tensor([5, 6], dtype=torch.int32, device=cuda_device))
    for k, v in before.items():
        assert torch.equal(server.cache[k], v), k


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
