"""Transformer layers: norms, rotary (M-RoPE included), attention, MLP, MoE.

Ported from ``repro.models.layers``. The two attention functions are plain
PyTorch copies of the JAX package's jnp twins, op for op, and live beside
their kernels as the kernels' plain versions; this module re-exports
them for the model:

* ``flash_attention_plain`` (``kernels/flash_attention/ref.py``) is
  ``jnp_flash_attention``: a chunked online softmax over KV blocks with
  the ``-1e30`` sentinel. On CPU tensors the kernel's wrapper runs it.
* ``decode_partials_plain`` (``kernels/flash_decode/ref.py``) is
  ``_decode_partials_jnp``, the flash_decode kernel's math with
  ``valid_len`` masking.

The MoE is the reference's sort-based capacity dispatch on one device
(``moe_block`` with ``mesh=None``); the expert-parallel path and the
S-sharded decode wait for multi-device (ROADMAP queue 1 items 12, 14.7).
Every function here keeps its shapes fixed and reads nothing back to the
host, so a decode step built from them can be captured into a CUDA graph.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG, flash_attention_plain)
from repro_torch.kernels.flash_decode.ref import decode_partials_plain  # noqa: F401


# ---------------------------------------------------------------------------
# norms + rotary
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def add_rms_norm(x: torch.Tensor, a: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-6):
    """The residual add and the norm after it: (x + a, rms_norm(x + a, g)),
    as XLA computes the JAX package's blocks under jit. The residual stream
    is rounded to x's dtype, but the add fuses into the norm, which reads
    the sum unrounded, in float32. In float32 this is the plain pair."""
    s = x.float() + a.float()
    var = torch.mean(torch.square(s), dim=-1, keepdim=True)
    return s.to(x.dtype), (s * torch.rsqrt(var + eps)).to(x.dtype) * g


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int. Rotates interleaved pairs
    (``x[..., ::2]``, ``x[..., 1::2]``), as the JAX package does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # [B,S,hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Sequence[int] = (16, 24, 24),
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: the hd/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position id. x: [B, S, H,
    hd] with hd/2 <= sum(sections) (at hd/2 <= 16 every slot is in section
    t); positions3: [3, B, S] int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    # section of each frequency slot, from device arithmetic alone (no host
    # copy, so the function captures)
    slot = torch.arange(hd // 2, device=x.device)
    sec = torch.zeros_like(slot)
    bound = 0
    for s in sections[:-1]:
        bound += s
        sec += (slot >= bound).long()
    pos = positions3[sec].movedim(0, -1)  # [B, S, hd/2]
    ang = pos.float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it, one rounding per op in x's dtype
    (``F.silu`` rounds once and differs by a bf16 ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form, op for op in x's dtype with its
    constants rounded to that dtype, as XLA computes it (``F.gelu`` rounds
    once and differs in a third of bf16 outputs)."""
    c = [float(torch.tensor(v, dtype=x.dtype)) for v in (np.sqrt(2 / np.pi), 0.044715)]
    cdf = 0.5 * (1.0 + torch.tanh(c[0] * (x + c[1] * (x * (x * x)))))
    return x * cdf


def mlp(x: torch.Tensor, w_gate: Optional[torch.Tensor], w_in: torch.Tensor,
        w_out: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = silu(x @ w_gate) * (x @ w_in)
    elif act == "squared_relu":
        h = torch.square(torch.relu(x @ w_in))
    elif act == "gelu":
        h = gelu(x @ w_in)
    else:
        raise ValueError(act)
    return h @ w_out


# ---------------------------------------------------------------------------
# MoE: sort-based capacity dispatch (GShard-style)
# ---------------------------------------------------------------------------

DROPLESS_TOKENS = 256  # up to this many tokens every assignment is kept


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: dropless up to 256 tokens (decode,
    small batches), else ``capacity_factor * t * k / E`` + 1, at least 4."""
    mo = cfg.moe
    if t <= DROPLESS_TOKENS:
        return t
    return max(int(mo.capacity_factor * t * mo.top_k / mo.n_experts) + 1, 4)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: among equal values the lower
    index comes first, which ``torch.topk`` does not promise."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """Gates and experts of each token: the top k of the router's softmax,
    renormalized to sum to one. The reference casts ``x @ router_w`` to
    float32, and XLA folds that cast into the product: the logits are the
    float32 sums of the inputs' products, never rounded to x's dtype."""
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
    topv, tope = top_k(gates, k)
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), tope


def _moe_dispatch_compute(x, router_w, e_gate, e_in, e_out, cfg,
                          e_lo: int, e_count: int) -> torch.Tensor:
    """Route, sort-dispatch to experts [e_lo, e_lo+e_count), compute,
    weighted-combine; ``repro.models.layers._moe_dispatch_compute``, whose
    ``e_total`` is always the config's expert count, which ``capacity``
    reads.

    Assignments go to their expert's slots in a stable sort by expert
    (token order within an expert); those past ``capacity`` slots, or
    outside this range of experts, land in a drop row that is discarded.
    The combine adds each token's kept contributions one after another in
    the activation dtype, in the expert-sorted order in which the
    reference's scatter-add meets them: the same sums, with no atomics, so
    the result does not vary from run to run."""
    t, d = x.shape
    k = cfg.moe.top_k
    cap = capacity(cfg, t)
    dev = x.device
    topv, tope = route(x, router_w, k)
    n = t * k
    flat_e, flat_w = tope.reshape(n), topv.reshape(n)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(n)
    local = (flat_e >= e_lo) & (flat_e < e_lo + e_count)
    flat_e = torch.where(local, flat_e - e_lo, e_count)
    se, order = torch.sort(flat_e, stable=True)  # grouped by expert
    sw, stok = flat_w[order], flat_tok[order]
    seg_start = torch.searchsorted(se, torch.arange(e_count, device=dev))
    pos_in_e = torch.arange(n, device=dev) - seg_start[torch.clamp(se, max=e_count - 1)]
    keep = (pos_in_e < cap) & (se < e_count)
    drop = e_count * cap
    slot = torch.where(keep, se * cap + pos_in_e, drop)
    buf = torch.zeros((drop + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = x[stok]  # only the drop row takes more than one write
    buf = buf[:-1].reshape(e_count, cap, d)
    if cfg.act == "swiglu":
        h = silu(torch.bmm(buf, e_gate)) * torch.bmm(buf, e_in)
    else:
        h = gelu(torch.bmm(buf, e_in))
    y = torch.bmm(h, e_out).reshape(drop, d)
    y = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=dev)])
    contrib = (y[slot] * sw[:, None].to(y.dtype)).to(x.dtype)  # dropped: zero
    # each token's k contributions in sorted order: the positions its
    # assignments took in the sort, ascending
    where = torch.empty_like(order)
    where[order] = torch.arange(n, device=dev)
    parts = contrib[where.view(t, k).sort(dim=1).values]  # [T, k, D]
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def moe_block(x, router_w, e_gate, e_in, e_out, cfg, mesh=None) -> torch.Tensor:
    """x: [T, D]. Sort-based capacity dispatch over all experts on one
    device (the reference's ``mesh=None`` path)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_block: expert parallelism over a mesh is not ported "
            "(ROADMAP queue 1 item 12 / 14.7)")
    return _moe_dispatch_compute(x, router_w, e_gate, e_in, e_out, cfg, 0,
                                 cfg.moe.n_experts)
