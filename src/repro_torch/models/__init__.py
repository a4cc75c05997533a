"""Language models of the port, mirroring ``repro.models``.

config.py — ModelConfig dataclass (a copy of the JAX package's)
layers.py — norms, rotary, plain attention (the kernels' plain versions), MLP
lm.py     — init / forward / prefill / decode of the dense GQA family
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig"]
