from repro_torch.kernels.block_matmul import ops, ref  # noqa: F401
