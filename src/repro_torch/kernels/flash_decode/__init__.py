from repro_torch.kernels.flash_decode import ops, ref  # noqa: F401
