"""Plain PyTorch version of forest inference (mean vote over complete trees)."""
import torch


def forest_predict(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                   leaf: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    n_trees, n_nodes = feat.shape
    depth = (n_nodes + 1).bit_length() - 1
    feat = feat.long().clamp(0, d - 1)
    node = torch.zeros((n, n_trees), dtype=torch.long, device=x.device)
    t_idx = torch.arange(n_trees, device=x.device)[None, :]
    for _ in range(depth):
        f = feat[t_idx, node]
        th = thresh[t_idx, node]
        xv = torch.gather(x, 1, f)
        node = 2 * node + 1 + (xv > th).long()
    leaf_idx = node - n_nodes
    return leaf[t_idx, leaf_idx].mean(dim=1)
