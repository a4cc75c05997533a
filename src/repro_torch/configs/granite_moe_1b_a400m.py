"""granite-moe-1b-a400m — 24L d=1024 16H(kv8) MoE 32e top-8 d_expert=512
vocab=49155. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config():
    return ModelConfig(
        name="granite-moe-1b-a400m", kind="moe", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=0, vocab=49155, head_dim=64,
        act="swiglu", attn="gqa",
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base")


def smoke_config():
    return ModelConfig(
        name="granite-moe-smoke", kind="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=0, vocab=128, head_dim=16,
        act="swiglu", attn="gqa", remat=False, loss_chunk=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32))
