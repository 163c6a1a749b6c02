"""The HTTP services (v1 point clouds, v2 textured assets) on the PyTorch pipeline."""
