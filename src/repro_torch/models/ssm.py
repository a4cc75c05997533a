"""Sequence-state models: the chunked gated-linear-attention core, the
Mamba-2 block, mLSTM and sLSTM.

Ported from ``repro.models.ssm``, function for function, in plain PyTorch:
the reference runs no Pallas kernel here. Mamba-2 and mLSTM are the same
chunkwise recurrence with different gates:

    S_t = a_t * S_{t-1} + g_t * k_t v_t^T ;  y_t = q_t . S_t

computed per chunk as an intra-chunk attention with the decay matrix
D_ij = exp(L_i - L_j) plus the carried state (``jax.lax.scan`` over chunks
becomes a Python loop over them). sLSTM is a sequential scan over tokens.

Types follow JAX's promotion: a bf16 operand meeting a float32 one is
computed in float32 (``torch.matmul`` refuses mixed types, so each product
casts its bf16 side up, never the float32 side down), and a Python constant
takes the tensor's type before it is used, as JAX's weak types do (0.999
is 1.0 in bf16). In bf16 the reference's elementwise chains round after
every op, under ``jax.jit`` as eagerly; ``softplus``, ``layers.sigmoid``
and ``cumsum`` copy them so (``F.softplus`` also returns x itself above 20,
``torch.sigmoid`` and ``torch.cumsum`` round differently). Each function
returns its new state and leaves the state it was given as it was; the LM's
decode step copies the new state into its cache in place.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import sigmoid, silu


def _const(v: float, x: torch.Tensor) -> float:
    """The Python constant v in x's type, as JAX's weak typing rounds it."""
    return float(torch.tensor(v, dtype=x.dtype))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), op for op in x's type; right for any x."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


SCAN_BLOCK = 16  # XLA's CPU scan splits a cumulative sum into blocks of 16


def cumsum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``jnp.cumsum`` as XLA computes it: each block of ``SCAN_BLOCK``
    elements summed in order, then each block offset by the running sum of
    the blocks before it, every add rounded to x's type. In bf16 the order
    matters: ``torch.cumsum`` differs by up to an ulp of the sum, which the
    decay matrix exp(L_i - L_j) turns into a visible error. The blocks are
    summed side by side (``SCAN_BLOCK`` adds in all, not one per element)."""
    x = x.movedim(dim, 0)
    n, rest = x.shape[0], x.shape[1:]
    nb = -(-n // SCAN_BLOCK)
    pad = x.new_zeros((nb * SCAN_BLOCK - n,) + rest)  # after the last element: inert
    xb = torch.cat([x, pad]).reshape((nb, SCAN_BLOCK) + rest)
    outs = [xb[:, 0]]
    for j in range(1, SCAN_BLOCK):
        outs.append(outs[-1] + xb[:, j])
    out = torch.stack(outs, dim=1)                          # [nb, BLOCK, ...]
    if nb > 1:  # offset blocks 1.. by the running sum of the totals before them
        offs = cumsum(out[:-1, -1], 0)
        out = torch.cat([out[:1], out[1:] + offs[:, None]])
    return out.reshape((nb * SCAN_BLOCK,) + rest)[:n].movedim(0, dim)


def chunked_gla(q, k, v, log_a, gate, chunk: int = 128,
                state0: Optional[torch.Tensor] = None):
    """q, k: [B,S,H,dk]; v: [B,S,H,dv]; log_a, gate: [B,S,H]. Returns (y
    [B,S,H,dv] float32, final state [B,H,dk,dv] float32). A ragged S is
    padded to whole chunks with zeros (a padded token neither decays nor
    writes the state) and cut off the output."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a, gate = (F.pad(t, (0, 0, 0, pad)) for t in (log_a, gate))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    S = (state0 if state0 is not None
         else torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device))
    # every chunk's inclusive decay sums at once: [B, nc, C, H]
    L_all = cumsum(log_a.reshape(b, nc, chunk, h), dim=2)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        L, g = L_all[:, c], gate[:, sl]                     # [B,C,H]
        total = L[:, -1:, :]
        # intra-chunk: D_ij = exp(L_i - L_j) for j <= i, times gate_j. The
        # mask goes inside the exp: above the diagonal L_i - L_j is the
        # chunk's decay negated and can pass float32's range, and the
        # reference's where(tri, exp(Ld), 0) then has a gradient of 0 * inf
        # = NaN there (xlstm-1.3b at full width, 128-token chunks); the
        # values are the same, and so is every gradient that is finite
        Ld = L[:, :, None, :] - L[:, None, :, :]             # [B,C,C,H]
        D = torch.exp(torch.where(tri[None, :, :, None], Ld, float("-inf")))
        sc = torch.einsum("bihd,bjhd->bijh", qb, kb)
        w = sc * D * g[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhd->bihd", w, vb)
        # inter-chunk, from the carried state
        qs = qb * torch.exp(L)[..., None]
        y_inter = torch.einsum("bihk,bhkv->bihv", qs, S)
        # S' = S exp(total) + sum_j exp(total - L_j) g_j k_j v_j^T
        decay_j = torch.exp(total - L) * g
        kS = torch.einsum("bjhk,bjhv->bhkv", kb * decay_j[..., None], vb)
        S = S * torch.exp(total)[:, 0, :, None, None] + kS
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], S


def gla_decode_step(S, q, k, v, log_a, gate):
    """One token of the recurrence. S: [B,H,dk,dv]; q, k: [B,H,dk]; v:
    [B,H,dv]; log_a, gate: [B,H]. Returns (y [B,H,dv], S'). The reference's
    ``(k * gate).astype(float32)`` is one float32 product under XLA (the
    cast absorbs the bf16 rounding of the product), so it is here."""
    a = torch.exp(log_a)[..., None, None]
    S_new = S * a + torch.einsum("bhk,bhv->bhkv", k.float() * gate.float()[..., None],
                                 v.float())
    return torch.einsum("bhk,bhkv->bhv", q.float(), S_new), S_new


# ---------------------------------------------------------------------------
# Mamba-2 block (SSD): conv -> gates -> chunked scan -> gated output
# ---------------------------------------------------------------------------

def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w: [W,C]: a depthwise causal convolution, its W taps
    added one after another in x's type, as the reference's loop."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def mamba2_forward(x, p, cfg, state: Optional[Tuple] = None, decode: bool = False,
                   heads: Optional[slice] = None):
    """x: [B,S,D] (S = 1 when decoding); p: one layer's params. state:
    (conv_state [B,W-1,d_in], ssm_state [B,H,dstate,dh]), read when decoding.
    Returns (out [B,S,D], (conv_state, ssm_state)).

    ``heads``: only these SSM heads (a contiguous block, a rank's under
    tensor parallelism): ``w_in``, ``w_z`` and ``conv_w`` hold their
    channels' columns and ``w_out`` their rows, the states theirs; ``dt`` of
    every head from the whole ``w_dt`` is sliced to them, as are ``dt_bias``,
    ``A_log`` and ``D_skip``; B and C are whole (one group shared by the
    heads). ``out`` is then these heads' part of the output, to be summed
    over the blocks. A leaf of any other width raises ValueError."""
    b, s, _ = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    dh = d_in // h
    sel = slice(None) if heads is None else heads
    if heads is not None:
        h = len(range(h)[heads])
        d_in = h * dh
        for name, dim in (("w_in", -1), ("w_z", -1), ("conv_w", -1), ("w_out", -2)):
            if p[name].shape[dim] != d_in:
                raise ValueError(f"mamba2_forward: {name} of {p[name].shape[dim]} channels "
                                 f"on dim {dim}, {h} heads want {d_in}")
    xz = x @ p["w_in"]                                     # [B,S,d_in]
    z = x @ p["w_z"]
    bc = x @ p["w_bc"]                                     # [B,S,2*dstate]
    dt = softplus(x @ p["w_dt"] + p["dt_bias"])[..., sel]  # [B,S,H]
    B_, C_ = bc.chunk(2, dim=-1)
    w = cfg.conv_width
    if decode:
        window = torch.cat([state[0], xz], dim=1)          # [B,W,d_in]
        xc = torch.einsum("bwd,wd->bd", window, p["conv_w"])[:, None, :]
        new_conv_state = window[:, 1:]
    else:
        xc = _causal_depthwise_conv(xz, p["conv_w"])
        new_conv_state = (xz[:, -(w - 1):] if s >= w - 1
                          else F.pad(xz, (0, 0, w - 1 - s, 0)))
    xh = silu(xc).reshape(b, -1, h, dh)                    # [B,S,H,dh]
    log_a = -dt * torch.exp(p["A_log"][sel])               # [B,S,H]
    # B_ and C_ shared across heads (one group)
    k = B_[:, :, None, :].expand(b, xh.shape[1], h, B_.shape[-1])
    q = C_[:, :, None, :].expand(k.shape)
    if decode:
        y, ssm_state = gla_decode_step(state[1], q[:, 0], k[:, 0], xh[:, 0],
                                       log_a[:, 0], dt[:, 0])
        y = y[:, None]
    else:
        y, ssm_state = chunked_gla(q, k, xh, log_a, dt)
    y = y + xh.float() * p["D_skip"][sel][None, None, :, None]
    y = y.reshape(b, -1, d_in).to(x.dtype) * silu(z)
    return y @ p["w_out"], (new_conv_state, ssm_state)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, chunkwise through the same core
# ---------------------------------------------------------------------------

def mlstm_forward(x, p, cfg, state: Optional[Tuple] = None, decode: bool = False,
                  heads: Optional[slice] = None):
    """x: [B,S,D]. Matrix-memory LSTM with a normalizer, tracked as a ones
    column appended to v; sigmoid input gates, as in the reference. state:
    (S [B,H,dh,dh+1],), the start state of a prefill or the decoded one.
    Returns (out [B,S,D], (S,)).

    ``heads``: only these heads (a contiguous block, a rank's under tensor
    parallelism): ``w_q``, ``w_k``, ``w_v`` and ``w_o`` hold their columns
    and ``w_out`` their rows, the state theirs; ``w_gates`` is whole (every
    head's input gates, then every head's forget gates) and its gates are
    sliced to them. ``out`` is then these heads' part of the output, to be
    summed over the blocks. A leaf of any other width raises ValueError."""
    b, s, _ = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    h_all = cfg.n_heads
    dh = d_in // h_all
    sel = slice(None) if heads is None else heads
    h = len(range(h_all)[sel])
    d_in = h * dh
    for name, dim in (("w_q", -1), ("w_k", -1), ("w_v", -1), ("w_o", -1), ("w_out", -2)):
        if p[name].shape[dim] != d_in:
            raise ValueError(f"mlstm_forward: {name} of {p[name].shape[dim]} channels on "
                             f"dim {dim}, {h} heads want {d_in}")
    q = (x @ p["w_q"]).reshape(b, s, h, dh)
    k = (x @ p["w_k"]).reshape(b, s, h, dh) * _const(dh ** -0.5, x)
    v = (x @ p["w_v"]).reshape(b, s, h, dh)
    gates = x @ p["w_gates"]                               # [B,S,2H]
    i_g = sigmoid(gates[..., :h_all][..., sel])
    f_g = sigmoid(gates[..., h_all:][..., sel]) * _const(0.999, x) + _const(0.0005, x)
    log_a = torch.log(f_g)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if decode:
        y_aug, S = gla_decode_step(state[0], q[:, 0], k[:, 0], v_aug[:, 0],
                                   log_a[:, 0], i_g[:, 0])
        y_aug = y_aug[:, None]
    else:
        y_aug, S = chunked_gla(q, k, v_aug, log_a, i_g,
                               state0=state[0] if state is not None else None)
    y = y_aug[..., :dh] / torch.clamp(torch.abs(y_aug[..., dh:]), min=1e-2)
    y = y.reshape(b, -1, d_in).to(x.dtype)
    o = sigmoid(x @ p["w_o"])
    return (y * o) @ p["w_out"], (S,)


# ---------------------------------------------------------------------------
# sLSTM block: scalar memory, a sequential scan over tokens
# ---------------------------------------------------------------------------

def _slstm_cell(g, c, n):
    """One sLSTM token from its gates g [B,4D] (input and recurrent terms
    summed), state c, n [B,D], all float32. Returns the new (h, c, n)."""
    d = c.shape[-1]
    i_t = torch.exp(torch.clamp(g[..., :d], -10, 5))
    f_t = sigmoid(g[..., d:2 * d])
    z_t = torch.tanh(g[..., 2 * d:3 * d])
    o_t = sigmoid(g[..., 3 * d:])
    c = f_t * c + i_t * z_t
    n = f_t * n + i_t
    return o_t * c / torch.clamp(n, min=1.0), c, n


def slstm_forward(x, p, cfg, state: Optional[Tuple] = None, decode: bool = False,
                  gather: Optional[Callable] = None, cut: Optional[Callable] = None):
    """x: [B,S,D] (in the model's type, or float32); gates from the input
    and the recurrent hidden state, in float32 (the reference's float32
    token times its bf16 weights); the output in the weights' type. state:
    (h, c, n), each [B,D] float32, zeros if not given. Returns (out [B,S,D],
    (h, c, n)).

    Under tensor parallelism (the caller's collectives): ``gather`` takes a
    token's gates computed from column blocks of ``w_gates`` and
    ``r_gates`` [B, 4D / ways] to the whole [B, 4D] (an all-gather), each
    token; ``cut`` takes the hidden states [B,S,D] to the units whose rows
    of ``w_out`` p holds, and ``out`` is then their part, to be summed."""
    b, s, d = x.shape
    if state is None:
        state = tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    r_gates = p["r_gates"].float()
    # every token's input term in one product: the same sums as one a token
    xg = x[:, :1 if decode else s].float() @ p["w_gates"].float()   # [B,S,4D]
    steps = []
    h, c, n = state
    for t in range(xg.shape[1]):
        g = xg[:, t] + h @ r_gates
        h, c, n = _slstm_cell(g if gather is None else gather(g), c, n)
        steps.append(h)
    hs = torch.stack(steps, dim=1)
    if cut is not None:
        hs = cut(hs)
    return hs.to(p["w_out"].dtype) @ p["w_out"], (h, c, n)
