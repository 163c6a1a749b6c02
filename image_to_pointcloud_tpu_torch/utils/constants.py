"""Host-made constants (resampling matrices, normalization vectors, lookup
tables), kept on the device once made.

A forward captured into a CUDA graph may not copy from host memory: a
copy from pageable memory synchronizes the stream, which a capture
refuses, and a graph that recorded one would read a host buffer that is
later freed. So every constant the forward needs is made by
:func:`device_constant` on its first use, outside any capture (the eager
pass that precedes a capture), and the cached tensor is what the capture
reads from then on. The cache lives as long as the process, as the
graphs that read it do; it grows with the distinct sizes a process sees.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["device_constant"]

_CACHE: dict = {}
_LOCK = threading.Lock()


def device_constant(key: tuple, device: "str | torch.device", dtype: "torch.dtype | None",
                    build) -> torch.Tensor:
    """``torch.as_tensor(build(), dtype=dtype)`` on ``device``, made once
    per (``key``, device, dtype): ``key`` names what ``build`` returns (a
    numpy array or a nested sequence of numbers), ``dtype=None`` keeps the
    array's. The values are those of the conversion made in place, bit for
    bit. Made outside inference mode and autograd, so any caller may use
    it (a training forward too)."""
    device = torch.device(device)
    ck = (key, device, dtype)
    t = _CACHE.get(ck)
    if t is None:
        with torch.inference_mode(False), torch.no_grad():
            t = torch.as_tensor(build(), dtype=dtype).to(device)
        with _LOCK:
            t = _CACHE.setdefault(ck, t)
    return t
