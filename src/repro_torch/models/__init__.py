"""Language models of the port, mirroring ``repro.models``.

config.py — ModelConfig dataclass (a copy of the JAX package's)
layers.py — norms, rotary, plain attention (the kernels' plain versions), MLP, MoE
ssm.py    — chunked gated linear attention, Mamba-2, mLSTM, sLSTM
lm.py     — init / forward / prefill / decode of every family
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig"]
