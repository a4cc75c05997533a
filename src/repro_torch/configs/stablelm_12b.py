"""stablelm-12b — 40L d=5120 32H(kv8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b family]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="stablelm-12b", kind="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352, head_dim=160,
        act="swiglu", attn="gqa", fsdp=True,
        source="hf:stabilityai/stablelm-2-1_6b (scaled family)")


def smoke_config():
    return ModelConfig(
        name="stablelm-smoke", kind="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        act="swiglu", attn="gqa", remat=False, loss_chunk=16)
