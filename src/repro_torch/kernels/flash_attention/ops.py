"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/ops.py::flash_attention`` and
the Pallas kernel behind it (``kernel.py::flash_attention_pallas``), with
the same signature: q [B,Hq,S,D], k [B,Hkv,S,D] and v [B,Hkv,S,Dv] ->
[B,Hq,S,Dv], scale ``D**-0.5``. Dv is D for the GQA families and 128
against D 192 for MLA's prefill (deepseek-v2), as in the reference's jnp
twin. On CPU tensors it runs the plain version
(``ref.flash_attention_plain``); on CUDA tensors it launches the
kernel: bf16 on the tensor cores, f32 on the CUDA cores (the f32 bar of
2e-4 rules out bf16 products and TF32). The kernel reads KV head
``h // (Hq/Hkv)`` in place (no repeat copy), takes any strides over B, H
and S with unit stride on D (the model hands in ``[B,S,H,D]`` projections
as transposed views), and masks a ragged S itself (no padding copies). The
output has q's layout (with Dv columns). The bf16 instance copies rows in
16-byte pieces, so its operands must start on 16 bytes with strides a
multiple of 8. A (D, Dv) pair that the source does not instantiate raises
ValueError: V is never padded to D, and nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D, Dv) pairs instantiated in csrc/flash_attention.cu: the GQA families'
# head dims, MLA's prefill (deepseek-v2) and a narrow MLA pair for tests
HEAD_DIMS = frozenset({(16, 16), (32, 32), (64, 64), (128, 128), (160, 160),
                       (192, 128), (64, 32)})
launches = 0  # kernel launches since the last reset


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")


def check_instance(d: int, dv: int) -> None:
    """Raises ValueError unless the kernel instantiates the pair (d, dv)."""
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (D, Dv) = ({d}, {dv}) is not "
                         f"instantiated; the kernel takes {sorted(HEAD_DIMS)}")


def _out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty [B, Hq, S, dv] output with q's order of dimensions in memory
    (the model's transposed [B, S, H, D] views come back as such views)."""
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype, device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Hq, S, D]; k: [B, Hkv, Skv, D]; v: [B, Hkv, Skv, Dv] with
    Hq % Hkv == 0. Returns [B, Hq, S, Dv]."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal).transpose(1, 2)
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    check_instance(d, dv)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on D")
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16
                                          or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError(f"flash_attention: bf16 {name} must be 16-byte "
                             "aligned at every row")
    out = _out(q, dv)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)))
    with torch.cuda.device(q.device):
        rc = build.entry("flash_attention")(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, hq, hkv, sq, skv, d, dv, int(causal), DTYPES[q.dtype], d ** -0.5,
            strides, ctypes.c_void_p(common.stream_ptr(q)))
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed, CUDA error {rc}")
    launches += 1
    return out
