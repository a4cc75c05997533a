"""Plain versions of the flash_attention kernel.

``attention`` is the naive oracle of ``repro.kernels.flash_attention.ref``.
``flash_attention_plain`` is ``repro.models.layers.jnp_flash_attention``
copied op for op: the kernel's plain version, which its wrapper runs on CPU
tensors and the model runs on the CPU; asked, it also returns the rows'
log-sum-exp. ``flash_attention_bwd_plain`` is the backward kernels' plain
version: FlashAttention-2's gradient equations over KV chunks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30  # the masked-score sentinel of the JAX package


def attention(q, k, v, causal: bool = True, scale: float | None = None):
    """q,k,v: [BH, S, D] (kv may have different S)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device),
                          diagonal=sk - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, chunk: int = 1024,
                          scale: Optional[float] = None, return_lse: bool = False):
    """q: [B,S,H,hd]; k,v: [B,Skv,Hkv,hd]. Online-softmax loop over KV
    chunks; the causal mask is aligned top-left (``rows >= cols``). With
    ``return_lse`` also each row's log-sum-exp of its scaled scores, ``m +
    log(l)`` in float32 [B,S,H]: what the backward recomputes P from."""
    b, s, h, hd = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, n_chunks, chunk, hkv, hd)
    vc = v.reshape(b, n_chunks, chunk, hkv, dv)
    qg = q.reshape(b, s, hkv, group, hd).float()
    rows = torch.arange(s, device=q.device)
    acc = torch.zeros((b, hkv, s, group, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, s, group), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, s, group), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sc = torch.einsum("bsngd,bcnd->bnsgc", qg, kc[:, ci].float()) * scale
        cols = ci * chunk + torch.arange(chunk, device=q.device)
        valid = cols[None, :] < skv
        if causal:
            valid = valid & (rows[:, None] >= cols[None, :])
        sc = torch.where(valid[None, None, :, None, :], sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnsgc,bcnd->bnsgd", p, vc[:, ci].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 2, 1, 3, 4).reshape(b, s, h, dv).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse.permute(0, 2, 1, 3).reshape(b, s, h)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True, *,
                              chunk: int = 1024):
    """The gradients (dq, dk, dv) of ``flash_attention_plain`` at its output
    cotangent ``do``, in its layout: q [B,S,H,D], k [B,Skv,Hkv,D], v
    [B,Skv,Hkv,Dv], o and do [B,S,H,Dv], lse [B,S,H] (float32, as
    ``flash_attention_plain(..., return_lse=True)`` gives it). In float32,
    over KV chunks, FlashAttention-2's equations: P recomputed from lse
    (zero where the forward masked: past Skv and, causal, ``rows < cols``),
    ``Dr = rowsum(do * o)``, ``dv = P^T do``, ``dS = P * (do v^T - Dr)``,
    ``dq = dS k * scale``, ``dk = dS^T q * scale`` with ``scale = D**-0.5``
    (the forward's); a KV head's dk and dv sum over its group's query heads.
    Each gradient comes back in its input's type."""
    b, s, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    scale = d ** -0.5
    f32 = torch.float32
    qg = q.reshape(b, s, hkv, group, d).to(f32)
    dog = do.reshape(b, s, hkv, group, dv).to(f32)
    lg = lse.reshape(b, s, hkv, group).to(f32)
    dr = (dog * o.reshape(b, s, hkv, group, dv).to(f32)).sum(-1)
    rows = torch.arange(s, device=q.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for lo in range(0, skv, chunk):
        kc, vc = k[:, lo:lo + chunk].to(f32), v[:, lo:lo + chunk].to(f32)
        cols = lo + torch.arange(kc.shape[1], device=q.device)
        sc = torch.einsum("bsngd,bcnd->bsngc", qg, kc) * scale
        valid = (rows[:, None] >= cols[None, :]) if causal else torch.ones(
            (s, cols.shape[0]), dtype=torch.bool, device=q.device)
        p = torch.where(valid[None, :, None, None, :], torch.exp(sc - lg[..., None]), 0.0)
        dvs.append(torch.einsum("bsngc,bsngv->bcnv", p, dog))
        dp = torch.einsum("bsngv,bcnv->bsngc", dog, vc)
        ds = p * (dp - dr[..., None])
        dq = dq + torch.einsum("bsngc,bcnd->bsngd", ds, kc) * scale
        dks.append(torch.einsum("bsngc,bsngd->bcnd", ds, qg) * scale)
    return (dq.reshape(b, s, h, d).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))
