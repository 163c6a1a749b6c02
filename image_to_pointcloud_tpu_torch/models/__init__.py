"""Depth models (Depth-Anything-V2: DINOv2 encoder + DPT head) in PyTorch."""
