"""Plain PyTorch version of block_matmul: tile-relational matmul == x @ w."""
import torch


def block_matmul(x: torch.Tensor, w: torch.Tensor, n_tiles: int = 1) -> torch.Tensor:
    del n_tiles  # tiling is a physical detail; semantics are x @ w
    return (x.float() @ w.float()).to(x.dtype)
