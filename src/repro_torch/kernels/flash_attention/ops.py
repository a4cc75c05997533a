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

The forward (out and the rows' log-sum-exp) and the backward are the
custom operators ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd``: the plain version is their CPU
implementation, the kernels their ``cuda`` one. Each has a shape-only
(fake) implementation with the kernel's shapes, types and strides, which
refuses what the kernel refuses, so a model traces on ``meta`` tensors as
it runs on the card (``launch.dryrun``), and a FLOP formula
for ``torch.utils.flop_counter`` (the whole (row, key) rectangle, as
torch's own formulas for SDPA and its backward count it).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, common
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_plain,
                                                    flash_attention_plain)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D, Dv) pairs instantiated in csrc/flash_attention.cu: the GQA families'
# head dims, MLA's prefill (deepseek-v2) and a narrow MLA pair for tests
HEAD_DIMS = frozenset({(16, 16), (32, 32), (64, 64), (128, 128), (160, 160),
                       (192, 128), (64, 32)})
launches = 0  # forward kernel launches since the last reset
bwd_launches = 0  # backward calls (three or four kernels each) since the last reset


def bwd_flops(b: int, hq: int, sq: int, skv: int, d: int, dv: int, causal: bool) -> float:
    """Operations of the backward's five products over the (row, key) pairs
    the mask keeps: S = q k^T, dQ and dK over D, dP and dV over Dv, two
    operations a product term, so 2 (3 D + 2 Dv) a pair and head."""
    if causal:  # row i keeps keys j <= i below Skv
        n = min(sq, skv)
        pairs = n * (n + 1) // 2 + max(sq - skv, 0) * skv
    else:
        pairs = sq * skv
    return 2.0 * b * hq * pairs * (3 * d + 2 * dv)


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


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if not _kernel_layout(t):
        raise ValueError(f"flash_attention: {name} needs unit stride on D"
                         + (" and, in bf16, 16-byte aligned rows"
                            if t.dtype == torch.bfloat16 else ""))


def _kernel_layout(t: torch.Tensor) -> bool:
    """Unit stride on D and, in bf16, every row on 16 bytes."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        return False
    return t.dtype != torch.bfloat16 or not (
        t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)))


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(t.stride(i) for t in ts for i in range(3)))


def _lse(q: torch.Tensor, with_lse: bool) -> torch.Tensor:
    """The forward's float32 [B, Hq, S] log-sum-exp of each row, or an
    empty tensor when it is not asked for."""
    shape = tuple(q.shape[:3]) if with_lse else (0,)
    return torch.empty(shape, dtype=torch.float32, device=q.device)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    got = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, return_lse=with_lse)
    out, lse = _out(q, v.shape[3]), _lse(q, with_lse)
    if with_lse:
        got, row_lse = got
        lse.copy_(row_lse.transpose(1, 2))
    out.copy_(got.transpose(1, 2))
    return out, lse


def _fake_check(q, v) -> None:
    """What the kernel's path refuses, where the head dims are known (a
    symbolic size, under ``torch.compile``'s dynamic shapes, is not)."""
    d, dv = q.shape[3], v.shape[3]
    if isinstance(d, int) and isinstance(dv, int):
        check_instance(d, dv)


@_forward_op.register_fake
def _forward_fake(q, k, v, causal, with_lse):
    _fake_check(q, v)
    return _out(q, v.shape[3]), _lse(q, with_lse)


@_forward_op.register_kernel("cuda")
def _forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  with_lse: bool):
    global launches
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    check_instance(d, dv)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    out, lse = _out(q, dv), _lse(q, with_lse)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = build.entry("flash_attention")(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr() if with_lse else None),
            b, hq, hkv, sq, skv, d, dv, int(causal), DTYPES[q.dtype], d ** -0.5,
            _strides(q, k, v, out), ctypes.c_void_p(common.stream_ptr(q)))
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed, CUDA error {rc}")
    launches += 1
    return out, lse


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             with_lse: bool):
    """The forward kernel's (out, lse or None); lse is float32 [B, Hq, S]."""
    out, lse = _forward_op(q, k, v, causal, with_lse)
    return out, (lse if with_lse else None)


def _grads(q, k, v):
    return _out(q, q.shape[3]), _out(k, k.shape[3]), _out(v, v.shape[3])


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor,
                 causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    t = lambda x: x.transpose(1, 2)
    got = flash_attention_bwd_plain(t(q), t(k), t(v), t(o), t(lse), t(do), causal)
    out = _grads(q, k, v)
    for dst, g in zip(out, got):
        dst.copy_(t(g))
    return out


@_backward_op.register_fake
def _backward_fake(q, k, v, o, lse, do, causal):
    _fake_check(q, v)
    return _grads(q, k, v)


@_backward_op.register_kernel("cuda")
def _backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, causal: bool):
    global bwd_launches
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    check_instance(d, dv)
    if not _kernel_layout(do):
        do = do.contiguous()
    lse = lse.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_operand(name, t, q)
    if lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse on {lse.device}, q on {q.device}")
    dq, dk, dvv = _grads(q, k, v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    dr = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = build.entry("flash_attention_bwd")(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, do, lse, dr, dq, dk, dvv)),
            b, hq, hkv, sq, skv, d, dv, int(causal), DTYPES[q.dtype], d ** -0.5,
            _strides(q, k, v, o, do, dq, dk, dvv), ctypes.c_void_p(common.stream_ptr(q)))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: launch failed, CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dvv


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _forward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """S = q k^T and o = P v over every (row, key) pair, causal or not."""
    b, hq, sq, d = q_shape
    return 2 * b * hq * sq * k_shape[2] * (d + v_shape[3])


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """dV, dP, dQ and dK over every (row, key) pair: torch's formula for
    SDPA's backward (no recomputation of S counted)."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * sq * k_shape[2] * (d + v_shape[3])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """(dq, dk, dv) of ``flash_attention`` at the output cotangent ``do``:
    q [B,Hq,S,D], k [B,Hkv,Skv,D], v [B,Hkv,Skv,Dv], o and do [B,Hq,S,Dv],
    lse float32 [B,Hq,S] (the forward's). Each gradient has its input's
    type and order of dimensions in memory. On CUDA tensors the kernels of
    ``csrc/flash_attention_bwd.cu`` (Dr, then dK/dV in one pass or, at a
    head dim over 128, two, then dQ); a ``do`` off the kernel's layout is
    copied contiguous first."""
    _check(q, k, v)
    b, hq, sq, _ = q.shape
    dv = v.shape[3]
    if tuple(o.shape) != (b, hq, sq, dv) or tuple(do.shape) != tuple(o.shape) \
            or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: dtypes o {o.dtype}, do {do.dtype}, "
                        f"lse {lse.dtype}")
    return _backward_op(q, k, v, o, lse, do, causal)


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with a gradient: the forward kernel, which also
    writes the rows' log-sum-exp, saving q, k, v, o and lse; the backward
    kernels at the output's cotangent (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Hq, S, D]; k: [B, Hkv, Skv, D]; v: [B, Hkv, Skv, Dv] with
    Hq % Hkv == 0. Returns [B, Hq, S, Dv]; differentiable through
    ``FlashAttentionFn`` when grad mode is on and an input requires grad."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
