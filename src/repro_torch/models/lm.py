"""Language model of the GQA families: parameter init, forward, prefill, decode.

Ported from ``repro.models.lm``, the parts that the GQA families run:

* decoders with ``kind`` "dense" or "moe" and ``attn`` "gqa" or "mrope"
  (granite-3-2b, stablelm-12b, deepseek-67b, nemotron-4-15b,
  granite-moe-1b-a400m, qwen2-vl-72b);
* the encoder-decoder, ``kind == "encdec"`` with GQA attention
  (seamless-m4t-medium): ``encode``, then decoder layers that run
  self-attention, cross-attention over the encoder's memory and the FFN.

MLA (deepseek-v2), the hybrid (zamba2) and xLSTM raise
``NotImplementedError`` (ROADMAP queue 1 item 14).

Params are a plain dict of tensors with the JAX package's key names, the
blocks stacked on a leading layer axis (``params["blocks"]["wq"]`` is
[L, D, H*hd]); the layers run as a Python loop over that axis. Prefill
attention (self and cross) goes through the flash_attention kernel, decode
attention through the flash_decode kernel; on CPU tensors their wrappers
run the plain versions, op for op the JAX package's jnp functions.

Unlike the JAX package, ``decode_step`` updates the cache's K and V
tensors in place (the returned cache holds the same tensors and a new
``len``): a copy of a 1.3 GB cache per step would cost more than the step.
The step reads nothing back to the host, so ``launch.serve.Server``
captures it into one CUDA graph, as the reference's server jits it.
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

NORMS = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm")  # initialized to ones


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    decoder = cfg.kind in ("dense", "moe") and cfg.attn in ("gqa", "mrope")
    encdec = cfg.kind == "encdec" and cfg.attn == "gqa"
    if not (decoder or encdec):
        raise NotImplementedError(
            f"{cfg.name}: kind={cfg.kind!r} attn={cfg.attn!r} is not ported; the "
            "port runs the dense, MoE and M-RoPE GQA decoders and the GQA "
            "encoder-decoder (ROADMAP queue 1 item 14)")


# ===========================================================================
# parameter initialization
# ===========================================================================

def _dense_block_shapes(cfg: ModelConfig, n_layers: int) -> Dict[str, Tuple]:
    D, hd = cfg.d_model, cfg.hd
    s = {"ln1": (n_layers, D), "ln2": (n_layers, D),
         "wq": (n_layers, D, cfg.n_heads * hd),
         "wk": (n_layers, D, cfg.n_kv_heads * hd),
         "wv": (n_layers, D, cfg.n_kv_heads * hd),
         "wo": (n_layers, cfg.n_heads * hd, D)}
    if cfg.moe is not None:
        mo = cfg.moe
        s["router"] = (n_layers, D, mo.n_experts)
        s["e_in"] = (n_layers, mo.n_experts, D, mo.d_expert)
        s["e_out"] = (n_layers, mo.n_experts, mo.d_expert, D)
        if cfg.act == "swiglu":
            s["e_gate"] = (n_layers, mo.n_experts, D, mo.d_expert)
        if mo.n_shared:
            s["sh_in"] = (n_layers, D, mo.n_shared * mo.d_shared)
            s["sh_out"] = (n_layers, mo.n_shared * mo.d_shared, D)
            if cfg.act == "swiglu":
                s["sh_gate"] = (n_layers, D, mo.n_shared * mo.d_shared)
    else:
        s["w_in"] = (n_layers, D, cfg.d_ff)
        s["w_out"] = (n_layers, cfg.d_ff, D)
        if cfg.act == "swiglu":
            s["w_gate"] = (n_layers, D, cfg.d_ff)
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    D, V, hd = cfg.d_model, cfg.padded_vocab, cfg.hd
    tree: Dict[str, Any] = {"embed": (V, D), "final_norm": (D,),
                            "blocks": _dense_block_shapes(cfg, cfg.n_layers)}
    if cfg.kind == "encdec":
        n = cfg.n_layers
        tree["enc_blocks"] = _dense_block_shapes(cfg, cfg.enc_layers)
        tree["cross"] = {"ln_x": (n, D), "xq": (n, D, cfg.n_heads * hd),
                         "xk": (n, D, cfg.n_kv_heads * hd),
                         "xv": (n, D, cfg.n_kv_heads * hd),
                         "xo": (n, cfg.n_heads * hd, D)}
        tree["enc_norm"] = (D,)
    return tree


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

    def build(tree):  # leaves in the JAX tree's flattening order (sorted keys)
        return {n: build(v) if isinstance(v, dict) else mk(n, v)
                for n, v in sorted(tree.items())}

    return build(param_shapes(cfg))


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
# forward: decoder and encoder blocks
# ===========================================================================

def _rotate(q, k, cfg: ModelConfig, positions, pos3):
    if cfg.attn == "mrope":
        return (L.apply_mrope(q, pos3, theta=cfg.rope_theta),
                L.apply_mrope(k, pos3, theta=cfg.rope_theta))
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta))


def _attend(q, k, v, causal: bool):
    """q [B,S,H,hd], k and v [B,Skv,Hkv,hd] -> [B, S, H*hd]. They go to the
    kernel as [B,H,S,hd] views; o comes back in q's [B,S,H,hd] memory
    layout, so the reshape is free."""
    b, s = q.shape[:2]
    o = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2).reshape(b, s, -1)


def _attn_prefill(x, blk, cfg: ModelConfig, positions, pos3, causal=True):
    """Self-attention over x; returns its output and the rotated (k, v)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ blk["wq"]).view(b, s, cfg.n_heads, hd)
    k = (x @ blk["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ blk["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q, k = _rotate(q, k, cfg, positions, pos3)
    return _attend(q, k, v, causal) @ blk["wo"], (k, v)


def _cross_attn(x, xblk, cfg: ModelConfig, enc_h):
    """Cross-attention of x over the encoder's memory (no rotary, no mask)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ xblk["xq"]).view(b, s, cfg.n_heads, hd)
    k = (enc_h @ xblk["xk"]).view(b, -1, cfg.n_kv_heads, hd)
    v = (enc_h @ xblk["xv"]).view(b, -1, cfg.n_kv_heads, hd)
    return _attend(q, k, v, causal=False) @ xblk["xo"]


def _ffn(x, blk, cfg: ModelConfig):
    if cfg.moe is None:
        return L.mlp(x, blk.get("w_gate"), blk["w_in"], blk["w_out"], cfg.act)
    flat = x.reshape(-1, x.shape[-1])
    y = L.moe_block(flat, blk["router"], blk.get("e_gate"), blk["e_in"],
                    blk["e_out"], cfg)
    if cfg.moe.n_shared:
        y = y + L.mlp(flat, blk.get("sh_gate"), blk["sh_in"], blk["sh_out"], cfg.act)
    return y.reshape(x.shape)


def _stack(x, blocks, cfg: ModelConfig, positions, pos3, causal=True,
           cross=None, enc_h=None, cache=None):
    """The stacked layers of ``blocks`` over x: self-attention, then (with
    ``cross``) cross-attention over ``enc_h``, then the FFN. With ``cache``
    each layer's K and V go to its first S slots."""
    s = x.shape[1]
    for i in range(blocks["ln1"].shape[0]):
        blk = _layer(blocks, i)
        a, (k, v) = _attn_prefill(L.rms_norm(x, blk["ln1"]), blk, cfg, positions,
                                  pos3, causal)
        if cross is not None:
            xblk = _layer(cross, i)
            x, h = L.add_rms_norm(x, a, xblk["ln_x"])
            a = _cross_attn(h, xblk, cfg, enc_h)
        x, h = L.add_rms_norm(x, a, blk["ln2"])
        x = x + _ffn(h, blk, cfg)
        if cache is not None:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _pos3(cfg: ModelConfig, positions, pos3):
    """M-RoPE's [3, B, S] ids: the 1-D positions on all three rows unless
    given (the stubbed vision frontend supplies them)."""
    if cfg.attn != "mrope":
        return None
    if pos3 is None:
        return positions[None].expand(3, *positions.shape)
    return torch.as_tensor(pos3, device=positions.device)


def encode(params, cfg: ModelConfig, enc_embeds) -> torch.Tensor:
    """Encoder pass of the encoder-decoder: frame embeddings [B, S_src, D]
    (the stubbed modality frontend's output) -> memory [B, S_src, D]."""
    check_supported(cfg)
    if cfg.kind != "encdec" or enc_embeds is None:
        raise ValueError(f"{cfg.name}: encode needs an encoder-decoder and enc_embeds")
    e = torch.as_tensor(enc_embeds, device=params["embed"].device).to(_dt(cfg))
    b, s = e.shape[:2]
    e = _stack(e, params["enc_blocks"], cfg, _positions(b, s, e.device), None,
               causal=False)
    return L.rms_norm(e, params["enc_norm"])


def forward(params, cfg: ModelConfig, tokens, positions=None, pos3=None,
            enc_embeds=None) -> torch.Tensor:
    """Returns final hidden states [B, S, D]. tokens: [B, S] int (the
    decoder's input); enc_embeds: [B, S_src, D] for the encoder-decoder;
    pos3: [3, B, S] for M-RoPE."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, x.device)
    enc_h = encode(params, cfg, enc_embeds) if cfg.kind == "encdec" else None
    x = _stack(x, params["blocks"], cfg, positions, _pos3(cfg, positions, pos3),
               cross=params.get("cross"), enc_h=enc_h)
    return L.rms_norm(x, params["final_norm"])


# ===========================================================================
# serving: cache init, prefill, decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None):
    """An empty cache; the encoder-decoder's also holds an encoder memory
    ``enc_h`` of ``enc_len`` frames (zero by default, as the reference's
    server leaves it)."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
             "v": torch.zeros(shape, dtype=_dt(cfg), device=dev),
             "len": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.kind == "encdec":
        cache["enc_h"] = torch.zeros((batch, enc_len, cfg.d_model), dtype=_dt(cfg),
                                     device=dev)
    return cache


def _decode_attn(q, k_cache, v_cache, valid_len):
    """q: [B,H,hd]; caches [B,S,kv,hd]; valid_len: filled slots. A cache of
    no slots (an empty encoder memory) attends to nothing: the reference's
    softmax over zero keys gives zeros, and so does this, with no launch."""
    b, h, hd = q.shape
    if k_cache.shape[1] == 0:
        return torch.zeros_like(q)
    acc, _, l = fd_ops.gqa_decode_partials(q, k_cache, v_cache, valid_len)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, hd).to(q.dtype)


def make_decode_step(cfg: ModelConfig):
    """Returns decode_step(params, cache, token [B], enc_h=None) -> (logits
    [B,V], cache).

    The new K/V row goes to slot ``min(len, max_len - 1)``: JAX's
    ``dynamic_update_slice`` clamps its start the same way, and the
    attention then counts ``len + 1`` filled slots, as the JAX package does
    (all of them once ``len`` has passed ``max_len``). The
    encoder-decoder's cross-attention reads ``enc_h``, by default the
    cache's, and recomputes its K and V every step, as the reference does."""
    check_supported(cfg)
    hd = cfg.hd

    def layer(x, blk, k_cache, v_cache, slot, valid, positions, xblk, enc_h):
        b = x.shape[0]
        h = L.rms_norm(x, blk["ln1"])
        q = (h @ blk["wq"]).view(b, 1, cfg.n_heads, hd)
        k = (h @ blk["wk"]).view(b, 1, cfg.n_kv_heads, hd)
        v = (h @ blk["wv"]).view(b, 1, cfg.n_kv_heads, hd)
        q, k = _rotate(q, k, cfg, positions, _pos3(cfg, positions, None))
        k_cache.index_copy_(1, slot, k)
        v_cache.index_copy_(1, slot, v)
        o = _decode_attn(q[:, 0], k_cache, v_cache, valid)
        a = o.reshape(b, cfg.n_heads * hd) @ blk["wo"]
        if xblk is not None:
            x, h = L.add_rms_norm(x, a, xblk["ln_x"])
            q = (h @ xblk["xq"]).view(b, cfg.n_heads, hd)
            ke = (enc_h @ xblk["xk"]).view(b, -1, cfg.n_kv_heads, hd)
            ve = (enc_h @ xblk["xv"]).view(b, -1, cfg.n_kv_heads, hd)
            o = _decode_attn(q, ke, ve, ke.shape[1])
            a = o.reshape(b, cfg.n_heads * hd) @ xblk["xo"]
        x, h = L.add_rms_norm(x, a, blk["ln2"])
        return x + _ffn(h, blk, cfg)

    def decode_step(params, cache, token, enc_h=None):
        x = _embed(params, cfg, token)  # [B, D]
        dev = x.device
        clen = torch.as_tensor(cache["len"], dtype=torch.int32, device=dev)
        positions = clen.reshape(1, 1).expand(x.shape[0], 1)
        slot = torch.clamp(clen, max=cache["k"].shape[2] - 1).reshape(1).long()
        valid = clen + 1
        if enc_h is None:
            enc_h = cache.get("enc_h")
        blocks, cross = params["blocks"], params.get("cross")
        for i in range(_n_layers(params)):
            x = layer(x, _layer(blocks, i), cache["k"][i], cache["v"][i], slot,
                      valid, positions, None if cross is None else _layer(cross, i),
                      enc_h)
        logits = _logits(params, L.rms_norm(x, params["final_norm"]))
        cols = torch.arange(cfg.padded_vocab, device=dev)
        logits = torch.where(cols[None, :] < cfg.vocab, logits, L.NEG)
        return logits, dict(cache, len=valid)

    return decode_step


# ===========================================================================
# prefill: process a prompt, return (last-token logits, populated cache)
# ===========================================================================

def prefill(params, cfg: ModelConfig, tokens, max_len: int, enc_embeds=None,
            pos3=None):
    """Logits of the last token (no vocab mask, as in the JAX package) and
    a cache of ``max_len`` slots holding the prompt's K and V (and, for the
    encoder-decoder, the encoder's memory of ``enc_embeds``)."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill: prompt of {s} tokens exceeds max_len {max_len}")
    positions = _positions(b, s, x.device)
    shape = (_n_layers(params), b, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    enc_h = None
    if cfg.kind == "encdec":
        enc_h = cache["enc_h"] = encode(params, cfg, enc_embeds)
    x = _stack(x, params["blocks"], cfg, positions, _pos3(cfg, positions, pos3),
               cross=params.get("cross"), enc_h=enc_h, cache=cache)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _logits(params, L.rms_norm(x[:, -1], params["final_norm"])), cache
