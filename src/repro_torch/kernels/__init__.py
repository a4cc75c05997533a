"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), one package each
with its plain PyTorch version (``ref.py``) and its wrapper (``ops.py``)."""
