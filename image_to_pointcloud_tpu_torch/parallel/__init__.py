"""Parallel execution: high-resolution tiling (``tiling.py``)."""
