from repro_torch.kernels.decision_forest import ops, ref  # noqa: F401
