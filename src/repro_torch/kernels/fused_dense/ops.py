"""Wrapper of the fused_dense kernel (``csrc/fused_dense.cu``).

Replaces ``src/repro/kernels/fused_dense/ops.py::fused_dense`` and the
Pallas kernel behind it (``kernel.py::fused_dense_pallas``). On a CPU tensor
it runs the plain version (``ref.py``); on a CUDA tensor it launches the
kernel. An activation the kernel does not have (softmax included) raises
``ValueError`` before anything runs, on either device.

The call goes through the custom operator ``repro_torch::fused_dense``, so
that it keeps running inside a CUDA-graph capture and under
``torch.func.vmap``, whose batching rule folds the batch axis into the rows
and launches the kernel once (a batched weight or bias raises). Its
shape-only (fake) implementation and FLOP formula (2MNK, the product's)
serve launch analysis's traces on ``meta`` tensors.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, common
from repro_torch.kernels.fused_dense import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {a: i for i, a in enumerate(ref.ACTS)}  # order of csrc's enum Act
launches = 0  # kernel launches since the last reset


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                act: str = "identity") -> torch.Tensor:
    if act not in ACT_CODES:
        raise ValueError(f"fused_dense: unsupported activation {act!r}")
    if (x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]
            or tuple(b.shape) != (w.shape[1],)):
        raise ValueError(f"fused_dense: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} + {tuple(b.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"fused_dense: dtypes {x.dtype}, {w.dtype}, {b.dtype}")
    return _fused_dense_op(x, w, b, act)


@torch.library.custom_op("repro_torch::fused_dense", mutates_args=(),
                         device_types="cpu")
def _fused_dense_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    act: str) -> torch.Tensor:
    return ref.fused_dense(x, w, b, act)


@_fused_dense_op.register_kernel("cuda")
def _fused_dense_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      act: str) -> torch.Tensor:
    global launches
    common.check_cuda_operands("fused_dense", x, w, b)
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=x.dtype, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.entry("fused_dense")(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            m, n, k, ACT_CODES[act], DTYPES[x.dtype],
            ctypes.c_void_p(common.stream_ptr(x)))
    if rc != 0:
        raise RuntimeError(f"fused_dense: launch failed, CUDA error {rc}")
    launches += 1
    return out


@_fused_dense_op.register_fake
def _fused_dense_fake(x, w, b, act):
    return x.new_empty((x.shape[0], w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.fused_dense)
def _fused_dense_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


@_fused_dense_op.register_vmap
def _fused_dense_vmap(info, in_dims, x, w, b, act):
    x_dim, w_dim, b_dim, _ = in_dims
    common.unbatched_param("fused_dense", w_dim)
    common.unbatched_param("fused_dense", b_dim)
    rows, bs, m = common.fold_rows(x, x_dim)
    return common.unfold_rows(_fused_dense_op(rows, w, b, act), bs, m), 0
