"""The v1 HTTP service on the PyTorch pipeline."""
