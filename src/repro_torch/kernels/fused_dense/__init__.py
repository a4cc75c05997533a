from repro_torch.kernels.fused_dense import ops, ref  # noqa: F401
