"""granite-3-2b — 40L d=2048 32H(kv8) d_ff=8192 vocab=49155 GQA.
[hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="granite-3-2b", kind="dense", n_layers=40, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
        act="swiglu", attn="gqa",
        source="hf:ibm-granite/granite-3.0-2b-base")


def smoke_config():
    return ModelConfig(
        name="granite-3-smoke", kind="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        act="swiglu", attn="gqa", remat=False, loss_chunk=16)
