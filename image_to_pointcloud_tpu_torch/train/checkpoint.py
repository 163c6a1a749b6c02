"""Checkpoint save/restore in the port's own format.

Stands in for the JAX package's orbax checkpoints
(``image_to_pointcloud_tpu/train/checkpoint.py``), which PyTorch cannot
read: ``<path>/checkpoint.pt`` holds ``{"params": state_dict, "step":
int}`` and, for resuming, ``"opt_state"`` (the optimizer's
``state_dict``). It is written to a temp file and moved into place with
``os.replace``, so a crash leaves the old checkpoint or the new one, and
read with ``torch.load(weights_only=True, map_location="cpu")``, which
unpickles tensors and plain containers only. The server
(``serve/models.py``) loads ``<root>/<model>/torch/checkpoint.pt``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any

import torch

__all__ = ["CHECKPOINT_FILE", "save_checkpoint", "restore_checkpoint", "restore_params"]

CHECKPOINT_FILE = "checkpoint.pt"


def save_checkpoint(path: str | os.PathLike, params: dict, opt_state: Any = None, step: int = 0):
    """Write {params, opt_state?, step} to ``path/checkpoint.pt``
    (atomically); returns ``path``."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    ckpt: dict[str, Any] = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "step": int(step),
    }
    if opt_state is not None:
        ckpt["opt_state"] = opt_state
    fd, tmp = tempfile.mkstemp(dir=out, prefix=".checkpoint.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(ckpt, f)
        os.replace(tmp, out / CHECKPOINT_FILE)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    return path


def restore_checkpoint(path: str | os.PathLike) -> dict:
    """The checkpoint dict as saved by :func:`save_checkpoint`, on the CPU."""
    return torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu", weights_only=True)


def restore_params(path: str | os.PathLike, mesh: Any = None) -> dict:
    """The model's ``state_dict`` from a checkpoint; with ``mesh``, placed
    on its slots by the TP rules (``parallel.sharding.shard_params``)
    straight from host memory, as ``Sharded`` values."""
    params = restore_checkpoint(path)["params"]
    if mesh is not None:
        from image_to_pointcloud_tpu_torch.parallel.sharding import shard_params

        params = shard_params(params, mesh)
    return params
