"""nemotron-4-15b — 32L d=6144 48H(kv8) d_ff=24576 vocab=256000,
squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="nemotron-4-15b", kind="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000, head_dim=128,
        act="squared_relu", attn="gqa", fsdp=True,
        source="arXiv:2402.16819")


def smoke_config():
    return ModelConfig(
        name="nemotron-smoke", kind="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=128, head_dim=16,
        act="squared_relu", attn="gqa", remat=False, loss_chunk=16)
