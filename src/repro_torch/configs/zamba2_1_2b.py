"""zamba2-1.2b — 38 Mamba2 layers d=2048 + ONE shared attention+MLP block
(32H kv32, d_ff=8192) applied every 6 layers; ssm_state=64.
[arXiv:2411.15242] sub-quadratic backbone: runs long_500k."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="zamba2-1.2b", kind="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, head_dim=64,
        ssm_state=64, attn_every=6, subquadratic=True,
        source="arXiv:2411.15242")


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke", kind="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        ssm_state=16, attn_every=2, remat=False, loss_chunk=16,
        subquadratic=True)
