"""Shared kernel utilities."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. Raises when CUDA is missing and no device was asked for, so a run
    meant for the card never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0.0) -> torch.Tensor:
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw handle a
    kernel library's C entry point takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


# ---------------------------------------------------------------------------
# batching rules of the engine kernels' custom operators (torch.func.vmap)
# ---------------------------------------------------------------------------

def unbatched_param(name: str, dim) -> None:
    """The kernels batch their rows only: a weight is an ML function's
    parameter and is never batched by the serving tier's vmap."""
    if dim is not None:
        raise ValueError(f"{name}: a weight batched under vmap is not supported")


def fold_rows(x: torch.Tensor, dim: int):
    """x's vmap batch axis ``dim`` folded into its rows, so one launch serves
    the whole batch: [B, M, ...] -> [B*M, ...]. Returns the rows, B and M."""
    x = x.movedim(dim, 0)
    b, m = x.shape[0], x.shape[1]
    return x.reshape((b * m,) + tuple(x.shape[2:])).contiguous(), b, m


def unfold_rows(out: torch.Tensor, b: int, m: int) -> torch.Tensor:
    """The inverse of ``fold_rows`` on a kernel's output: [B*M, ...] -> [B, M, ...]."""
    return out.reshape((b, m) + tuple(out.shape[1:]))
