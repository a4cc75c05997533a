"""Transformer layers of the dense-GQA path: norms, rotary, attention, MLP.

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

M-RoPE, the S-sharded decode and the MoE functions are not ported yet
(ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it, one rounding per op in x's dtype
    (``F.silu`` rounds once and differs by a bf16 ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(x: torch.Tensor, w_gate: Optional[torch.Tensor], w_in: torch.Tensor,
        w_out: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = silu(x @ w_gate) * (x @ w_in)
    elif act == "squared_relu":
        h = torch.square(torch.relu(x @ w_in))
    elif act == "gelu":
        h = F.gelu(x @ w_in, approximate="tanh")  # jax.nn.gelu's default form
    else:
        raise ValueError(act)
    return h @ w_out
