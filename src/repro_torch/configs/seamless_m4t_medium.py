"""seamless-m4t-medium — enc-dec 12L+12L d=1024 16H(kv16) d_ff=4096
vocab=256206; audio frontend STUBBED (input_specs provides precomputed frame
embeddings). [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="seamless-m4t-medium", kind="encdec", n_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206, head_dim=64,
        act="gelu", attn="gqa", enc_layers=12,
        source="arXiv:2308.11596")


def smoke_config():
    return ModelConfig(
        name="seamless-smoke", kind="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        act="gelu", attn="gqa", enc_layers=2, remat=False, loss_chunk=16)
