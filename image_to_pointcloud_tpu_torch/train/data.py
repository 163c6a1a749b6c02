"""Input pipeline: double-buffered host→device staging for training.

Counterpart of ``image_to_pointcloud_tpu/train/data.py``. A background
thread stages the next batch on the device while the current step runs.
On CUDA the host arrays are pinned and copied ``non_blocking`` on a side
stream; the consumer's stream waits on an event recorded after the copy,
and each tensor is marked as used by that stream (``record_stream``), so
the step never reads a batch whose copy is still in flight and the
allocator never reuses its memory early.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device", "synthetic_depth_batches"]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_list(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _tree_zip(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn`` over the leaves of two trees of one structure."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_zip(fn, x, y) for x, y in zip(tree, other))
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a placed batch (every distinct shard of a
    :class:`~..parallel.sharding.Sharded` leaf)."""
    tensors: dict = {}
    for x in _tree_list(tree):
        for t in (x.shards.flat if hasattr(x, "shards") else [x]):
            tensors[id(t)] = t
    return list(tensors.values())


def prefetch_to_device(
    batches: Iterable[Any],
    *,
    size: int = 2,
    device: "str | torch.device" = "cuda",
    sharding: Any = None,
) -> Iterator[Any]:
    """Iterate ``batches`` (tuples, lists or dicts of numpy arrays) as
    tensors on ``device``, with ``size`` batches staged ahead: the copy of
    batch k+1 overlaps the step on batch k, classic double buffering with
    ``size=2``. With ``sharding`` (a ``NamedSharding`` of
    ``parallel/sharding.py``, or a function of the array giving one, e.g.
    ``lambda x: batch_sharding(mesh, x.ndim)``) each array is placed on the
    mesh's slots instead, as a ``Sharded``. Abandoning the iterator (an
    early break, an error, close) stops the worker and drops the staged
    batches; an error in ``batches`` is raised in the consumer."""
    from image_to_pointcloud_tpu_torch.parallel.sharding import device_put

    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()
    sides: dict = {}  # device -> its side stream, made at first use

    def target(x):
        if sharding is None:
            return device
        return sharding(x) if callable(sharding) else sharding

    def put(batch):
        targets = _tree_map(target, batch)
        devices = {device} if sharding is None else {
            d for t in _tree_list(targets) for d in t.mesh.devices.flat}
        cuda = sorted((d for d in devices if d.type == "cuda"), key=str)
        for d in cuda:
            sides.setdefault(d, torch.cuda.Stream(d))

        def place(x, where):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cuda:
                t = t.pin_memory()
            if isinstance(where, torch.device):
                return t.to(where, non_blocking=bool(cuda))
            return device_put(t, where, non_blocking=bool(cuda))

        with contextlib.ExitStack() as ctx:
            for d in cuda:
                ctx.enter_context(torch.cuda.stream(sides[d]))
            out = _tree_zip(place, batch, targets)
        done = []
        for d in cuda:
            e = torch.cuda.Event()
            e.record(sides[d])
            done.append((d, e))
        return out, done

    def enqueue(item) -> bool:
        # Bounded put with a stop check: if the consumer abandons the
        # iterator, a plain q.put would block this thread forever,
        # pinning `size` device-staged batches for the process lifetime.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not enqueue(put(b)) or stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            err.append(e)
        finally:
            enqueue(_END)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            batch, done = item
            for d, event in done:
                torch.cuda.current_stream(d).wait_event(event)
            if done:
                for t in _leaves(batch):
                    t.record_stream(torch.cuda.current_stream(t.device))
            yield batch
    finally:
        # Generator close/GC (GeneratorExit lands here): release the
        # worker and drop any staged batches so their memory frees.
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def synthetic_depth_batches(
    *,
    batch_size: int,
    image_hw: tuple[int, int],
    steps: int,
    seed: int = 0,
    depth_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(images f32 (B,H,W,3), depth targets f32 (B,H,W)) numpy batches,
    the JAX package's draws byte for byte.

    Default targets: smooth radial depth fields — enough signal for the
    fine-tuning loop to descend in tests/smoke runs without real data.
    """
    h, w = image_hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(steps):
        imgs = rng.normal(0, 1, (batch_size, h, w, 3)).astype(np.float32)
        if depth_fn is not None:
            depth = depth_fn(imgs)
        else:
            cx = rng.uniform(0.2, 0.8, batch_size) * w
            cy = rng.uniform(0.2, 0.8, batch_size) * h
            r = np.sqrt(
                (xx[None] - cx[:, None, None]) ** 2
                + (yy[None] - cy[:, None, None]) ** 2
            )
            depth = (0.5 + r / r.max()).astype(np.float32)
        yield imgs, depth
