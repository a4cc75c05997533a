"""deepseek-v2-236b — 60L d=5120 128H MLA(kv_lora=512) MoE 2 shared + 160
routed top-6 d_expert=1536 vocab=102400. [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig


def config():
    return ModelConfig(
        name="deepseek-v2-236b", kind="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=0, vocab=102400, head_dim=128,
        act="swiglu", attn="mla",
        mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128,
                      v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                      d_shared=1536),
        fsdp=True, source="arXiv:2405.04434")


def smoke_config():
    return ModelConfig(
        name="deepseek-v2-smoke", kind="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=128, head_dim=16,
        act="swiglu", attn="mla", remat=False, loss_chunk=16,
        mla=MLAConfig(kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16, v_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32, n_shared=1,
                      d_shared=32))
