"""Wrapper of the block_matmul kernel (``csrc/block_matmul.cu``).

Replaces ``src/repro/kernels/block_matmul/ops.py::block_matmul`` and the
Pallas kernel behind it (``kernel.py::block_matmul_pallas``). On a CPU
tensor it runs the plain version (``ref.py``); on a CUDA tensor it launches
the kernel, which masks ragged edges itself, so nothing is padded here.
``n_tiles`` keeps its meaning: the weight relation's columns are cut into
``n_tiles`` tiles of ``ceil(N / n_tiles)`` columns, and no thread block
straddles two tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.block_matmul import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0  # kernel launches since the last reset


def block_matmul(x: torch.Tensor, w: torch.Tensor, n_tiles: int = 8) -> torch.Tensor:
    global launches
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"block_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"block_matmul: dtypes {x.dtype}, {w.dtype}")
    if x.device.type == "cpu":
        return ref.block_matmul(x, w, n_tiles)
    common.check_cuda_operands("block_matmul", x, w)
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tile_w = common.cdiv(n, max(int(n_tiles), 1))
    with torch.cuda.device(x.device):
        rc = build.entry("block_matmul")(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), m, n, k, tile_w, DTYPES[x.dtype],
            ctypes.c_void_p(common.stream_ptr(x)))
    if rc != 0:
        raise RuntimeError(f"block_matmul: launch failed, CUDA error {rc}")
    launches += 1
    return out
