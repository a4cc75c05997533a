"""deepseek-67b — 95L d=8192 64H(kv8) d_ff=22016 vocab=102400, llama-arch.
[arXiv:2401.02954]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="deepseek-67b", kind="dense", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab=102400, head_dim=128,
        act="swiglu", attn="gqa", fsdp=True, source="arXiv:2401.02954")


def smoke_config():
    return ModelConfig(
        name="deepseek-67b-smoke", kind="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        act="swiglu", attn="gqa", remat=False, loss_chunk=16)
