"""Micro-batching queue: concurrent requests share forward passes.

Counterpart of ``image_to_pointcloud_tpu/serve/batching.py``. Concurrent
jobs with the same signature (the image size for decoded pixels, the
``JpegSpec`` for hybrid-JPEG items) and options coalesce into one
batched pipeline call; a short window (a few ms) bounds the added
latency, and an arrival-gap debounce dispatches a complete burst at
once. Up to two drains run concurrently, so the host collect of one
batch overlaps the device work of the next. Each group is padded to the
next of a fixed set of batch sizes (:func:`bucket_sizes`) with copies of
its last item, whose results are dropped: every batch size is a
signature of its own, a CUDA graph captured once (an XLA compile in the
JAX package), and the server's warmup captures every bucket.

A caller's ``timings`` dict gets its item's stages, in seconds and in
order: "batch.wait" (enqueued until its drain's submit starts: the window,
a drain slot, the executor's queue), the batch's "pipeline.pack" and
"pipeline.replay", "pipeline.collect_wait" (the submit's end until the
collect starts: the hop back to the event loop and into the executor
again), "pipeline.d2h_wait" and "pipeline.unbundle", and
"job.resume_wait" (the collect's end until the caller runs again).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import defaultdict
from typing import Any

import numpy as np

from image_to_pointcloud_tpu_torch.serve import metrics
from image_to_pointcloud_tpu_torch.pipeline.graph import (
    DepthPipeline,
    PipelineOptions,
    PipelineResult,
)

__all__ = ["BatchingQueue", "bucket_sizes"]

_DRAIN_DEPTH = 2


def bucket_sizes(max_batch: int) -> list[int]:
    """The batch sizes a drain dispatches: powers of two plus 3·2^k mid
    steps from 12 (12, 24, …), capped at ``max_batch``, which is one too.
    The mids exist because N lockstep clients land between powers of two
    (12 clients would pad to 16, a third of the work thrown away). Each
    bucket is one signature; the warmup captures them all."""
    sizes = {1, max_batch}
    b = 2
    while b <= max_batch:
        sizes.add(b)
        if 3 * b // 2 <= max_batch and b >= 8:
            sizes.add(3 * b // 2)
        b *= 2
    return sorted(sizes)


@dataclasses.dataclass
class _Item:
    # Decoded (H, W, 3) u8 pixels, or a pipeline.graph.JpegInput on the
    # hybrid device-decode ingest.
    image: Any
    depth_scale: float
    options: PipelineOptions
    future: asyncio.Future
    want_packed: bool = True
    timings: "dict | None" = None
    queued_at: float = dataclasses.field(default_factory=time.perf_counter)
    collected_at: float = 0.0

    @property
    def signature(self) -> Any:
        """Shape part of the grouping key: the pixel array's shape, or the
        JpegSpec of a hybrid item."""
        if isinstance(self.image, np.ndarray):
            return self.image.shape
        return self.image.spec


class BatchingQueue:
    def __init__(
        self,
        pipeline: DepthPipeline,
        *,
        max_batch: int = 8,
        window_ms: float = 5.0,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.window_ms = window_ms
        self._queue: asyncio.Queue[_Item] = asyncio.Queue()
        self._worker: asyncio.Task | None = None

    def _ensure_worker(self) -> None:
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        """Cancel the drain task (idempotent); pending submits get
        CancelledError."""
        if self._worker is not None and not self._worker.done():
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
        self._worker = None
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if not item.future.done():
                item.future.cancel()

    async def submit(
        self,
        image: Any,
        depth_scale: float,
        options: PipelineOptions,
        *,
        want_packed: bool = True,
        timings: "dict | None" = None,
    ) -> PipelineResult:
        """The item's result; its stages (the module's docstring) add to
        ``timings`` where given."""
        self._ensure_worker()
        fut = asyncio.get_running_loop().create_future()
        item = _Item(image, depth_scale, options, fut, want_packed, timings)
        await self._queue.put(item)
        res = await fut
        metrics.record("job.resume_wait", time.perf_counter() - item.collected_at, timings)
        return res

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(_DRAIN_DEPTH)
        pending: set[asyncio.Task] = set()
        batch: list[_Item] = []
        try:
            while True:
                batch = [await self._queue.get()]
                # Coalesce until full, the window expires, or no request
                # arrived for the debounce gap.
                deadline = loop.time() + self.window_ms / 1000.0
                debounce = min(0.025, self.window_ms / 1000.0 / 3.0)
                last_growth = loop.time()
                while True:
                    grew = False
                    while len(batch) < self.max_batch and not self._queue.empty():
                        batch.append(self._queue.get_nowait())
                        grew = True
                    now = loop.time()
                    if grew:
                        last_growth = now
                    if len(batch) >= self.max_batch or self.window_ms <= 0:
                        break
                    if now - last_growth >= debounce and len(batch) > 1:
                        break
                    if deadline - now <= 0:
                        break
                    await asyncio.sleep(min(0.005, deadline - now))
                await sem.acquire()
                # Requests that queued while both drains were busy join
                # this dispatch.
                while len(batch) < self.max_batch and not self._queue.empty():
                    batch.append(self._queue.get_nowait())
                task = loop.create_task(self._drain(batch, loop, sem))
                pending.add(task)
                task.add_done_callback(pending.discard)
        except asyncio.CancelledError:
            for item in batch:
                if not item.future.done():
                    item.future.cancel()
            for task in pending:
                task.cancel()
            raise

    async def _drain(self, batch: "list[_Item]", loop, sem: asyncio.Semaphore) -> None:
        try:
            groups: dict[tuple, list[_Item]] = defaultdict(list)
            for item in batch:
                groups[(item.signature, item.options)].append(item)
            for (_, options), items in groups.items():
                metrics.BATCH_SIZE.observe(len(items))
                # Padded to the next bucket with copies of the last item;
                # zip below drops the padding's results.
                n = len(items)
                bucket = next(b for b in bucket_sizes(self.max_batch) if b >= n)
                images = [i.image for i in items]
                scales = [i.depth_scale for i in items]
                images += [images[-1]] * (bucket - n)
                scales += [scales[-1]] * (bucket - n)
                want_packed = any(i.want_packed for i in items)
                submit = (
                    self.pipeline.submit_batch
                    if isinstance(images[0], np.ndarray)
                    else self.pipeline.submit_batch_jpeg
                )
                try:
                    t0 = time.perf_counter()
                    sub0, handle, sub1 = await loop.run_in_executor(
                        None,
                        _timed(lambda: submit(images, depth_scales=scales, options=options)),
                    )
                    t1 = time.perf_counter()
                    col0, results, col1 = await loop.run_in_executor(
                        None,
                        _timed(lambda: self.pipeline.collect(
                            handle,
                            want_packed=want_packed,
                            # Serving renders paletted PNGs from the gray
                            # preview; skip the RGB lookup.
                            want_preview_rgb=False,
                        )),
                    )
                    metrics.DRAIN_SUBMIT.observe(t1 - t0)
                    metrics.DRAIN_COLLECT.observe(time.perf_counter() - t1)
                    metrics.record("pipeline.collect_wait", col0 - sub1)
                    for item, res in zip(items, results):
                        metrics.record("batch.wait", sub0 - item.queued_at, item.timings)
                        if item.timings is not None:
                            item.timings.update(handle.stages)
                            item.timings["pipeline.collect_wait"] = col0 - sub1
                        item.collected_at = col1
                        if not item.future.done():
                            item.future.set_result(res)
                except Exception as e:  # noqa: BLE001 — resolve every waiter
                    for item in items:
                        if not item.future.done():
                            item.future.set_exception(e)
        except asyncio.CancelledError:
            for item in batch:
                if not item.future.done():
                    item.future.cancel()
            raise
        finally:
            sem.release()


def _timed(fn):
    """``fn`` → a callable returning (its start, its result, its end) on
    the host's clock, where it runs (an executor thread)."""

    def run():
        t0 = time.perf_counter()
        out = fn()
        return t0, out, time.perf_counter()

    return run
