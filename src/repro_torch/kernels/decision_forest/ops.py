"""Wrapper of the decision_forest kernel (``csrc/decision_forest.cu``).

Replaces ``src/repro/kernels/decision_forest/ops.py::forest_predict`` and
the Pallas kernel behind it (``kernel.py::forest_pallas``). No one-hot
feature selectors are built here: the kernel gathers features directly. On
a CPU tensor it runs the plain version (``ref.py``); on a CUDA tensor it
launches the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.decision_forest import ref

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
launches = 0  # kernel launches since the last reset


def forest_predict(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                   leaf: torch.Tensor) -> torch.Tensor:
    global launches
    n_trees, n_nodes = feat.shape
    depth = (n_nodes + 1).bit_length() - 1
    if (x.ndim != 2 or n_nodes != 2 ** depth - 1
            or tuple(thresh.shape) != (n_trees, n_nodes)
            or tuple(leaf.shape) != (n_trees, 2 ** depth)):
        raise ValueError(f"forest_predict: shapes x{tuple(x.shape)} "
                         f"feat{tuple(feat.shape)} thresh{tuple(thresh.shape)} "
                         f"leaf{tuple(leaf.shape)}")
    if (feat.dtype != torch.int32 or thresh.dtype != torch.float32
            or leaf.dtype != torch.float32):
        raise TypeError(f"forest_predict: dtypes {feat.dtype}, {thresh.dtype}, "
                        f"{leaf.dtype}")
    xf = x.float()
    if x.device.type == "cpu":
        return ref.forest_predict(xf, feat, thresh, leaf).to(x.dtype)
    common.check_cuda_operands("forest_predict", xf, feat, thresh, leaf)
    smem = (2 * n_nodes + 2 ** depth) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"forest_predict: depth {depth} needs {smem} bytes "
                         "of shared memory per tree")
    n, d = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.to(x.dtype)
    with torch.cuda.device(x.device):
        rc = build.entry("forest_predict")(
            ctypes.c_void_p(xf.data_ptr()), ctypes.c_void_p(feat.data_ptr()),
            ctypes.c_void_p(thresh.data_ptr()), ctypes.c_void_p(leaf.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, d, n_trees, depth,
            ctypes.c_void_p(common.stream_ptr(x)))
    if rc != 0:
        raise RuntimeError(f"forest_predict: launch failed, CUDA error {rc}")
    launches += 1
    return out.to(x.dtype)
