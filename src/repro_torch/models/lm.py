"""Dense-GQA language model: parameter init, forward, prefill and decode.

Ported from ``repro.models.lm``, the parts that the dense GQA family runs
(granite-3-2b, stablelm-12b, deepseek-67b, nemotron-4-15b): ``kind ==
"dense"`` with ``attn == "gqa"``. Every other kind or attention raises
``NotImplementedError`` (ROADMAP queue 1 item 14).

Params are a plain dict of tensors with the JAX package's key names, the
blocks stacked on a leading layer axis (``params["blocks"]["wq"]`` is
[L, D, H*hd]); the layers run as a Python loop over that axis. Prefill
attention goes through the flash_attention kernel, decode attention
through the flash_decode kernel; on CPU tensors their wrappers run the
plain versions, op for op the JAX package's jnp functions.

Unlike the JAX package, ``decode_step`` updates the cache's K and V
tensors in place (the returned cache holds the same tensors and a new
``len``): a copy of a 1.3 GB cache per step would cost more than the step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NORMS = ("ln1", "ln2", "final_norm")  # initialized to ones


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    if cfg.kind != "dense" or cfg.attn != "gqa" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: kind={cfg.kind!r} attn={cfg.attn!r} is not ported; the "
            "port runs dense GQA models only (ROADMAP queue 1 item 14)")


# ===========================================================================
# parameter initialization
# ===========================================================================

def _dense_block_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D, hd = cfg.d_model, cfg.hd
    s = {"ln1": (n_layers, D), "ln2": (n_layers, D),
         "wq": (n_layers, D, cfg.n_heads * hd),
         "wk": (n_layers, D, cfg.n_kv_heads * hd),
         "wv": (n_layers, D, cfg.n_kv_heads * hd),
         "wo": (n_layers, cfg.n_heads * hd, D),
         "w_in": (n_layers, D, cfg.d_ff), "w_out": (n_layers, cfg.d_ff, D)}
    if cfg.act == "swiglu":
        s["w_gate"] = (n_layers, D, cfg.d_ff)
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    return {"embed": (V, D), "final_norm": (D,),
            "blocks": _dense_block_shapes(cfg, cfg.n_layers)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random params with the JAX package's scheme: normal / sqrt(fan_in),
    norms at one. The numbers come from a ``torch.Generator`` seeded with
    ``seed`` on the target device, so they differ from ``jax.random``'s;
    tests carry JAX params across with ``convert.lm_params_from_numpy``."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(name, shape):
        if name in NORMS:
            return torch.ones(shape, dtype=dt, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.div_(np.sqrt(max(shape[-2], 1))).to(dt)

    shapes = param_shapes(cfg)
    # leaves in the JAX tree's flattening order (sorted keys)
    params: Dict[str, Any] = {"blocks": {n: mk(n, shapes["blocks"][n])
                                         for n in sorted(shapes["blocks"])}}
    params["embed"] = mk("embed", shapes["embed"])
    params["final_norm"] = mk("final_norm", shapes["final_norm"])
    return params


def _layer(blocks: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: w[i] for k, w in blocks.items()}


def _n_layers(params) -> int:
    return params["blocks"]["ln1"].shape[0]


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    # JAX's gather wraps negative ids once and clamps the rest into range
    n = emb.shape[0]
    tokens = torch.where(tokens < 0, tokens + n, tokens).clamp(0, n - 1)
    return emb[tokens].to(_dt(cfg))


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["embed"].float().T


# ===========================================================================
# forward: dense GQA decoder blocks
# ===========================================================================

def _attn_prefill(x, blk, cfg: ModelConfig, positions, with_kv=False):
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ blk["wq"]).view(b, s, cfg.n_heads, hd)
    k = (x @ blk["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ blk["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # [B,S,H,hd] projections go in as [B,H,S,hd] views; o comes back in
    # q's [B,S,H,hd] memory layout, so the reshape below is free
    o = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd) @ blk["wo"]
    if with_kv:
        return out, (k, v)
    return out


def _ffn(x, blk, cfg: ModelConfig):
    return L.mlp(x, blk.get("w_gate"), blk["w_in"], blk["w_out"], cfg.act)


def _decoder_block(x, blk, cfg: ModelConfig, positions):
    x = x + _attn_prefill(L.rms_norm(x, blk["ln1"]), blk, cfg, positions)
    return x + _ffn(L.rms_norm(x, blk["ln2"]), blk, cfg)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params, cfg: ModelConfig, tokens, positions=None) -> torch.Tensor:
    """Returns final hidden states [B, S, D]. tokens: [B, S] int."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, x.device)
    blocks = params["blocks"]
    for i in range(_n_layers(params)):
        x = _decoder_block(x, _layer(blocks, i), cfg, positions)
    return L.rms_norm(x, params["final_norm"])


# ===========================================================================
# serving: cache init, prefill, decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def _decode_attn(q, k_cache, v_cache, valid_len):
    """q: [B,H,hd]; caches [B,S,kv,hd]; valid_len: filled slots."""
    b, h, hd = q.shape
    acc, _, l = fd_ops.gqa_decode_partials(q, k_cache, v_cache, valid_len)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, hd).to(q.dtype)


def make_decode_step(cfg: ModelConfig):
    """Returns decode_step(params, cache, token [B]) -> (logits [B,V], cache).

    The new K/V row goes to slot ``min(len, max_len - 1)``: JAX's
    ``dynamic_update_slice`` clamps its start the same way, and the
    attention then counts ``len + 1`` filled slots, as the JAX package does
    (all of them once ``len`` has passed ``max_len``)."""
    check_supported(cfg)
    hd = cfg.hd

    def gqa_layer(x, blk, k_cache, v_cache, slot, valid, positions):
        b = x.shape[0]
        h = L.rms_norm(x, blk["ln1"])
        q = (h @ blk["wq"]).view(b, 1, cfg.n_heads, hd)
        k = (h @ blk["wk"]).view(b, 1, cfg.n_kv_heads, hd)
        v = (h @ blk["wv"]).view(b, 1, cfg.n_kv_heads, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        k_cache.index_copy_(1, slot, k)
        v_cache.index_copy_(1, slot, v)
        o = _decode_attn(q[:, 0], k_cache, v_cache, valid)
        x = x + o.reshape(b, cfg.n_heads * hd) @ blk["wo"]
        return x + _ffn(L.rms_norm(x, blk["ln2"]), blk, cfg)

    def decode_step(params, cache, token):
        x = _embed(params, cfg, token)  # [B, D]
        dev = x.device
        clen = torch.as_tensor(cache["len"], dtype=torch.int32, device=dev)
        positions = clen.reshape(1, 1).expand(x.shape[0], 1)
        slot = torch.clamp(clen, max=cache["k"].shape[2] - 1).reshape(1).long()
        valid = clen + 1
        blocks = params["blocks"]
        for i in range(_n_layers(params)):
            x = gqa_layer(x, _layer(blocks, i), cache["k"][i], cache["v"][i],
                          slot, valid, positions)
        logits = _logits(params, L.rms_norm(x, params["final_norm"]))
        cols = torch.arange(cfg.padded_vocab, device=dev)
        logits = torch.where(cols[None, :] < cfg.vocab, logits, L.NEG)
        return logits, dict(cache, len=valid)

    return decode_step


# ===========================================================================
# prefill: process a prompt, return (last-token logits, populated cache)
# ===========================================================================

def prefill(params, cfg: ModelConfig, tokens, max_len: int):
    """Logits of the last token (no vocab mask, as in the JAX package) and
    a cache of ``max_len`` slots holding the prompt's K and V."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len {max_len}")
    positions = _positions(b, s, x.device)
    n_layers = _n_layers(params)
    shape = (n_layers, b, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    blocks = params["blocks"]
    for i in range(n_layers):
        blk = _layer(blocks, i)
        a, (k, v) = _attn_prefill(L.rms_norm(x, blk["ln1"]), blk, cfg, positions,
                                  with_kv=True)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        x = x + a
        x = x + _ffn(L.rms_norm(x, blk["ln2"]), blk, cfg)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _logits(params, L.rms_norm(x[:, -1], params["final_norm"])), cache
