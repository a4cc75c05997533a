"""Plain versions of the flash_decode kernel.

``decode_attention``, ``decode_partials`` and ``merge_partials`` are the
oracle of ``repro.kernels.flash_decode.ref``: full-softmax one-token
attention and the partial (acc, m, l) form used for merging over cache
shards. ``decode_partials_plain`` is ``repro.models.layers.
_decode_partials_jnp`` copied op for op, with ``valid_len`` masking: the
kernel's plain version, which its wrappers run on CPU tensors.
"""
import torch

from repro_torch.kernels.flash_attention.ref import NEG


def decode_attention(q, k, v, scale=None):
    """q: [BH, G, D]; k,v: [BH, S, D] -> [BH, G, D]."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bgs,bsd->bgd", p, v.float())


def decode_partials(q, k, v, scale=None):
    """Reference (acc, m, l) partials over the full local block."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgs,bsd->bgd", p, v.float())
    return acc, m[..., 0], l[..., 0]


def merge_partials(accs, ms, ls):
    """Merge per-shard partials (lists) into the exact softmax output."""
    m_all = torch.stack(ms).amax(dim=0)
    num = 0.0
    den = 0.0
    for acc, m, l in zip(accs, ms, ls):
        w = torch.exp(m - m_all)
        num = num + acc * w[..., None]
        den = den + l * w
    return num / den[..., None]


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len, scale: float):
    """q: [B,H,hd]; k,v: [B,Sloc,Hkv,hd]; valid_len: how many slots are
    filled (an int or a 0-d tensor). Returns the unnormalized partials
    acc [B,Hkv,G,hd], m and l [B,Hkv,G], all float32."""
    b, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)
    s = torch.einsum("bngd,bcnd->bngc", qg.float(), k.float()) * scale
    cols = torch.arange(k.shape[1], device=q.device)
    s = torch.where(cols[None, None, None, :] < valid_len, s, NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bngc,bcnd->bngd", p, v.float())
    return acc, m, l
