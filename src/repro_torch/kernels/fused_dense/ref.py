"""Plain PyTorch version of fused_dense: act(x @ w + b) in f32."""
import torch
import torch.nn.functional as F

ACTS = ("identity", "relu", "sigmoid", "tanh", "gelu", "squared_relu")


def apply_act(act: str, y: torch.Tensor) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")  # jax.nn.gelu's default form
    if act == "squared_relu":
        return torch.square(torch.relu(y))
    if act == "identity":
        return y
    raise ValueError(act)


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str) -> torch.Tensor:
    y = x.float() @ w.float() + b.float()
    return apply_act(act, y).to(x.dtype)
