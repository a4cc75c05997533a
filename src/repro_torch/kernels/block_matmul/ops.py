"""Wrapper of the block_matmul kernel (``csrc/block_matmul.cu``).

Replaces ``src/repro/kernels/block_matmul/ops.py::block_matmul`` and the
Pallas kernel behind it (``kernel.py::block_matmul_pallas``). On a CPU
tensor it runs the plain version (``ref.py``); on a CUDA tensor it launches
the kernel, which masks ragged edges itself, so nothing is padded here.
``n_tiles`` keeps its meaning: the weight relation's columns are cut into
``n_tiles`` tiles of ``ceil(N / n_tiles)`` columns, and no thread block
straddles two tiles.

The call goes through the custom operator ``repro_torch::block_matmul``
(plain version on the CPU, kernel on CUDA), so that it keeps running inside
a CUDA-graph capture and under ``torch.func.vmap``: its batching rule folds
the batch axis into the rows and launches the kernel once (the weight, an
ML function's parameter, is never batched; a batched one raises). Its
shape-only (fake) implementation and FLOP formula (2MNK) serve launch
analysis's traces on ``meta`` tensors.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, common
from repro_torch.kernels.block_matmul import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0  # kernel launches since the last reset


def block_matmul(x: torch.Tensor, w: torch.Tensor, n_tiles: int = 8) -> torch.Tensor:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"block_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"block_matmul: dtypes {x.dtype}, {w.dtype}")
    return _block_matmul_op(x, w, int(n_tiles))


@torch.library.custom_op("repro_torch::block_matmul", mutates_args=(),
                         device_types="cpu")
def _block_matmul_op(x: torch.Tensor, w: torch.Tensor, n_tiles: int) -> torch.Tensor:
    return ref.block_matmul(x, w, n_tiles)


@_block_matmul_op.register_kernel("cuda")
def _block_matmul_cuda(x: torch.Tensor, w: torch.Tensor, n_tiles: int) -> torch.Tensor:
    global launches
    common.check_cuda_operands("block_matmul", x, w)
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tile_w = common.cdiv(n, max(n_tiles, 1))
    with torch.cuda.device(x.device):
        rc = build.entry("block_matmul")(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), m, n, k, tile_w, DTYPES[x.dtype],
            ctypes.c_void_p(common.stream_ptr(x)))
    if rc != 0:
        raise RuntimeError(f"block_matmul: launch failed, CUDA error {rc}")
    launches += 1
    return out


@_block_matmul_op.register_fake
def _block_matmul_fake(x, w, n_tiles):
    return x.new_empty((x.shape[0], w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.block_matmul)
def _block_matmul_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


@_block_matmul_op.register_vmap
def _block_matmul_vmap(info, in_dims, x, w, n_tiles):
    x_dim, w_dim, _ = in_dims
    common.unbatched_param("block_matmul", w_dim)
    rows, b, m = common.fold_rows(x, x_dim)
    return common.unfold_rows(_block_matmul_op(rows, w, n_tiles), b, m), 0
