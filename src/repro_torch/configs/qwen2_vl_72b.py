"""qwen2-vl-72b — 80L d=8192 64H(kv8) d_ff=29568 vocab=152064, M-RoPE;
vision frontend STUBBED (text backbone; pos3 ids supplied by input_specs).
[arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="qwen2-vl-72b", kind="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, head_dim=128,
        act="swiglu", attn="mrope", rope_theta=1e6, fsdp=True,
        source="arXiv:2409.12191")


def smoke_config():
    return ModelConfig(
        name="qwen2-vl-smoke", kind="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128, head_dim=16,
        act="swiglu", attn="mrope", rope_theta=1e6, remat=False,
        loss_chunk=16)
