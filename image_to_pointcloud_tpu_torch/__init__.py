"""image_to_pointcloud_tpu_torch — the image→point-cloud system in PyTorch
on an NVIDIA H100.

A port of :mod:`image_to_pointcloud_tpu` (JAX/Flax/Pallas on TPU), which
stays beside it as the reference. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built by ``nvcc`` at first use (:mod:`.cuda`). The layout
mirrors the JAX package: ``models/``, ``ops/``, ``pipeline/``,
``serve/``. Host-side modules that import no JAX (``io/``, ``native/``,
``pipeline/meshing.py``, ``core/config.py`` and the HTTP layer of
``serve/``) are imported from the JAX package as they are.

This package imports no JAX.
"""

__version__ = "0.1.0"
