"""The parallel layer: device meshes, model-axis storage and torch.distributed."""
