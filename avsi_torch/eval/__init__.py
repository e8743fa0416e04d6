from avsi_torch.eval import harness, metrics  # noqa: F401
