"""image_to_pointcloud_tpu_torch — the image→point-cloud system in PyTorch
on an NVIDIA H100.

A port of :mod:`image_to_pointcloud_tpu` (JAX/Flax/Pallas on TPU), which
stays beside it as the reference. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built by ``nvcc`` at first use (:mod:`.cuda`). The layout
mirrors the JAX package: ``models/``, ``ops/``, ``pipeline/``,
``serve/``. The host-side modules (``io/``, ``native/``,
``pipeline/meshing.py``, ``core/config.py``, ``utils/logging.py`` and the
HTTP layer of ``serve/``) are the port's own copies of the JAX package's,
byte for byte in what they write; the C++ host library under ``native/``
is built by ``g++`` at first use into ``native/build/``.

This package imports no JAX and nothing of :mod:`image_to_pointcloud_tpu`.
"""

__version__ = "0.1.0"
