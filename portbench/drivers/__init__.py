"""Traffic drivers: one general driver a kind of traffic, configured by a
data file under ``portbench/traffic/``. ``run(ctx)`` runs the set-up and
the measured window of one cell and returns its records."""

from __future__ import annotations

import time


def build_program() -> float:
    """Build the port's CUDA kernels and its native host library where
    the checkout lacks them (each at a fixed path in the checkout, so only
    a checkout's first run builds); the seconds it took."""
    t0 = time.perf_counter()
    from image_to_pointcloud_tpu_torch import cuda, native

    cuda.library()
    native.available()
    return time.perf_counter() - t0
