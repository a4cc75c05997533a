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

The MoE is the reference's sort-based capacity dispatch. On a (data,
model) mesh of ``torch.distributed`` ranks (``core.mesh.make_host_mesh``)
two functions take the reference's ``shard_map`` paths, each rank running
the body on its own block and the collectives joining them:

* ``sharded_decode_attention``: one token's attention over a cache whose
  slots are split over ``model`` (and rows over ``data``), each rank's
  partials from the flash_decode kernel on its own slice, merged by
  log-sum-exp (``lse_merge``);
* ``moe_block(mesh=)``: expert parallelism, each rank's experts over its
  tokens, the combine one all-reduce over ``model``.

Every function here keeps its shapes fixed and reads nothing back to the
host, so a one-device decode step built from them can be captured into a
CUDA graph (a step on a mesh runs eagerly: gloo's collectives cannot be
captured).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import mesh as mesh_util
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG, flash_attention_plain)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_partials_plain  # noqa: F401
from repro_torch.models.sharding import axis_size, batch_rows, sharded_experts


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


def rms_norm_of_product(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm(x @ w, g)`` as XLA computes it under jit when x is one row
    a token ([B, D], as in decode): the norm reads the product in float32,
    before it is rounded to x's type, and rounds its own output to x's type."""
    p = x.float() @ w.float()
    var = torch.mean(torch.square(p), dim=-1, keepdim=True)
    return (p * torch.rsqrt(var + eps)).to(x.dtype) * g


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
# attention: decode over an S-sharded cache (partials + log-sum-exp merge)
# ---------------------------------------------------------------------------

def lse_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, mesh,
              axis: str = "model") -> torch.Tensor:
    """The exact softmax output from every rank's unnormalized partials
    (acc [..., D], m and l [...], float32) over ``axis``, as the reference
    merges them: the max of the m's, then the sums of ``acc * w`` and
    ``l * w`` with ``w = exp(m - max)`` (one all-reduce of both), then
    ``num / max(den, 1e-30)``. A rank whose slice held no valid slot has
    ``m = -1e30`` and weighs zero."""
    m_all = mesh_util.all_reduce_max(m, mesh, axis)
    w = torch.exp(m - m_all)
    both = mesh_util.all_reduce_sum(torch.cat([acc * w[..., None], (l * w)[..., None]], -1),
                                    mesh, axis)
    return both[..., :-1] / torch.clamp(both[..., -1], min=1e-30)[..., None]


def gather_batch(x: torch.Tensor, rows: Optional[slice], mesh) -> torch.Tensor:
    """A batch-sharded result back to the whole batch on every rank."""
    return x if rows is None else mesh_util.all_gather_rows(x, mesh, "data")


def sharded_decode_attention(q: torch.Tensor, k_local: torch.Tensor,
                             v_local: torch.Tensor, cache_len, mesh,
                             seq_axis: str = "model") -> torch.Tensor:
    """One-token attention with the cache's S axis split over ``seq_axis``
    (``repro.models.layers.sharded_decode_attention``).

    q: [B, H, hd], whole on every rank; k_local, v_local: this rank's
    [B_loc, S_loc, Hkv, hd] block of the cache (``sharding.shard_cache``):
    its rows of the batch when B divides over ``data`` (else all B), its
    slots ``[rank * S_loc, (rank + 1) * S_loc)``. ``cache_len``: the
    filled slots of the whole cache (an int32 tensor on q's device). Each
    rank counts its own on the device, ``clamp(cache_len - rank * S_loc,
    0, S_loc)``, takes its partials from the flash_decode kernel (its plain
    version on the CPU) and merges them over ``seq_axis``; a batch-sharded
    output is all-gathered over ``data``. Returns [B, H, hd] in q's type."""
    b, h, hd = q.shape
    s_loc = k_local.shape[1]
    rows = batch_rows(mesh, b)
    ql = q if rows is None else q[rows]
    if k_local.shape[0] != ql.shape[0]:
        raise ValueError(f"sharded_decode_attention: a cache block of {k_local.shape[0]} "
                         f"rows for {ql.shape[0]} of the batch's {b}")
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    start = mesh_util.rank_of(mesh, seq_axis) * s_loc
    valid = torch.clamp(clen - start, 0, s_loc)
    acc, m, l = fd_ops.gqa_decode_partials(ql, k_local, v_local, valid)
    out = gather_batch(lse_merge(acc, m, l, mesh, seq_axis), rows, mesh)
    return out.reshape(b, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it, 1 / (1 + exp(-x)) with one
    rounding per op in x's dtype (``torch.sigmoid`` rounds once and differs
    in a sixth of bf16 outputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it, one rounding per op in x's dtype
    (``F.silu`` rounds once and differs by a bf16 ulp)."""
    return x * sigmoid(x)


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
_DROPS: Optional[list] = None  # while ``count_drops`` runs: a count a dispatch


@contextlib.contextmanager
def count_drops():
    """Yields a list that holds, for each expert dispatch inside the block,
    the number of this rank's (token, expert) assignments past capacity (a
    0-d tensor on the tokens' device; nothing is read back here)."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


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
    if _DROPS is not None:
        _DROPS.append(((se < e_count) & ~keep).sum())
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


def moe_block(x, router_w, e_gate, e_in, e_out, cfg, mesh=None,
              local_rows: bool = False) -> torch.Tensor:
    """x: [T, D]. Sort-based capacity dispatch (GShard-style).

    ``mesh=None``, a mesh without a ``model`` axis, or an expert count that
    does not divide over it: every expert on this device (the reference's
    single-device path). Otherwise expert parallelism, as the reference's
    ``shard_map``: the expert leaves are this rank's block of ``E / model``
    experts (``sharding.shard_params``), the tokens this rank's rows when T
    divides over ``data`` (capacity counts the local tokens), and the
    combine is one all-reduce sum of the [T_loc, D] output over ``model``,
    in x's type as the reference's psum; a batch-sharded output is then
    all-gathered over ``data``. ``local_rows``: x is already this rank's
    tokens over ``data`` (data-parallel training), split no further.

    Under autograd the collectives carry the gradient
    (``core.mesh.{sum_over,copy_to,split_rows,gather_rows}``): x and the
    router enter the experts' split with their gradients summed over
    ``model``, and where the tokens split here over ``data`` the router's
    and experts' gradients are summed over ``data`` too, so that every
    rank ends with the whole gradient of its leaves. The forward is the
    same computation either way."""
    e = cfg.moe.n_experts
    if not sharded_experts(cfg, mesh):
        return _moe_dispatch_compute(x, router_w, e_gate, e_in, e_out, cfg, 0, e)
    e_loc = e // axis_size(mesh, "model")
    if e_in.shape[0] != e_loc:
        raise ValueError(f"moe_block: {e_in.shape[0]} experts on this rank, its block "
                         f"is {e_loc} of {e} (sharding.shard_params)")
    rows = None if local_rows else batch_rows(mesh, x.shape[0])
    ws = [router_w, e_gate, e_in, e_out]
    if rows is not None:
        x = mesh_util.split_rows(x, mesh, "data")
        ws = [w if w is None else mesh_util.copy_to(w, mesh, "data") for w in ws]
    x, ws[0] = (mesh_util.copy_to(t, mesh, "model") for t in (x, ws[0]))
    out = _moe_dispatch_compute(x, *ws, cfg, mesh_util.rank_of(mesh, "model") * e_loc, e_loc)
    out = mesh_util.sum_over(out, mesh, "model")
    return out if rows is None else mesh_util.gather_rows(out, mesh, "data", sum_grads=False)
