"""xlstm-1.3b — 48L d=2048 4H mLSTM+sLSTM (7:1), vocab=50304.
[arXiv:2405.04517] sub-quadratic: runs long_500k."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="xlstm-1.3b", kind="xlstm", n_layers=48, d_model=2048,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=8,
        subquadratic=True, source="arXiv:2405.04517")


def smoke_config():
    return ModelConfig(
        name="xlstm-smoke", kind="xlstm", n_layers=4, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=0, vocab=128, slstm_every=2,
        remat=False, loss_chunk=16, subquadratic=True)
