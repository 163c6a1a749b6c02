"""Job registry: the reference's in-memory dict, done safely + durably.

Reference semantics (backend/app.py:40, 642-647; backend/main.py:47):
UUID job ids, states pending → processing → completed | error, integer
progress 0-100, a human message, results attached on completion. The
reference mutates a bare module dict from background tasks (benign only
under the GIL, SURVEY.md §5) and **loses every job on process restart**
(SURVEY.md §5 checkpoint/resume: none). Here a single-writer registry
guards all mutation with an asyncio lock, supports the v2 list/delete
surface, and can journal job state to disk: on restart, finished jobs
(and their download URLs) survive; jobs that were mid-flight are marked
failed with an explanatory message instead of vanishing.

Journaled results are slimmed (inline preview arrays / depth PNGs are
dropped) — the artifacts on disk are the durable part, and the frontend
regenerates previews client-side when the arrays are absent (its P2/P3
fallback chain, reference App.jsx:805-897).
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import os
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["JobStatus", "Job", "JobRegistry"]

logger = logging.getLogger(__name__)

# Heavy inline payloads not worth journaling (regenerable client-side).
_EPHEMERAL_RESULT_KEYS = ("preview", "meshPreview", "depthMap", "preview_data")


class JobStatus:
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    ERROR = "error"


@dataclass
class Job:
    job_id: str
    status: str = JobStatus.PENDING
    progress: int = 0
    message: str = "Job queued"
    results: Any = None
    created_at: str = ""
    model: str = ""
    extra: dict = field(default_factory=dict)

    def terminal_body(self, render) -> bytes:
        """Cached JSON encoding of a terminal job's status payload.

        Terminal bodies are immutable and can be multi-MB (the inline
        20k-point preview), so both API generations serialize them once
        (~126 ms of host core measured per re-dump) and serve cached
        bytes. Lives in ``extra`` — not journaled, dies with the job.
        ``render`` is ``to_v1``/``to_v2``-style (called only on miss).
        """
        body = self.extra.get("_status_body")
        if body is None:
            from image_to_pointcloud_tpu_torch.serve.rawjson import dumps_raw

            body = dumps_raw(render())
            self.extra["_status_body"] = body
        return body

    def to_v1(self) -> dict:
        return {
            "job_id": self.job_id,
            "status": self.status,
            "progress": self.progress,
            "message": self.message,
            "results": self.results,
        }

    def to_v2(self) -> dict:
        out = {
            "job_id": self.job_id,
            "status": self.status,
            "progress": self.progress,
            "message": self.message,
            "created_at": self.created_at,
            "model": self.model,
        }
        if self.status == JobStatus.COMPLETED and self.results:
            out["results"] = self.results
        return out


def _slim_results(results: Any) -> Any:
    if not isinstance(results, dict):
        return results
    return {k: v for k, v in results.items() if k not in _EPHEMERAL_RESULT_KEYS}


class JobRegistry:
    """In-memory registry with an optional append-only JSONL journal.

    Journal records are full job snapshots (``{"op": "put"|"delete", ...}``);
    replay keeps the last state per id. Progress-only updates are not
    journaled — only terminal transitions and creation — so the journal
    stays small and the write path off the polling hot loop.
    """

    # Terminal jobs younger than this are never evicted: clients polling
    # at the reference's 1.5 s cadence must always see their results.
    EVICT_GRACE_S = 60.0

    def __init__(
        self,
        journal_path: str | os.PathLike | None = None,
        max_jobs: int | None = None,
        on_evict: Any = None,
    ) -> None:
        """``max_jobs``: optional retention cap — when exceeded, the
        longest-finished terminal jobs (past a grace window; in-flight
        jobs never) are evicted. The reference keeps every job forever
        (unbounded RAM growth, SURVEY.md §8 quirk 8); None preserves
        that behavior. ``on_evict(job)`` lets the owner clean up the
        job's on-disk artifacts."""
        self._jobs: dict[str, Job] = {}
        self._lock = asyncio.Lock()
        self._max_jobs = max_jobs
        self._on_evict = on_evict
        self._journal: Any = None
        self._journal_path: Path | None = None
        self._records = 0  # appends since last compaction
        if journal_path is not None:
            path = Path(journal_path)
            path.parent.mkdir(parents=True, exist_ok=True)
            self._journal_path = path
            self._replay(path)
            self._journal = self._open_journal(path)
            self._compact(path)

    @staticmethod
    def _open_journal(path: Path):
        """Open for append with an exclusive lock: two processes sharing
        one journal (e.g. v1 and v2 started from the same output dir)
        would silently disconnect each other on compaction's
        os.replace — fail loudly instead."""
        f = open(path, "a", encoding="utf-8")
        try:
            import fcntl

            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            f.close()
            raise RuntimeError(
                f"jobs journal {path} is owned by another process; "
                "run each service with its own --output-dir (or disable "
                "durable_jobs)"
            ) from None
        except ImportError:  # non-unix: no flock; best effort
            pass
        return f

    # ---------- persistence ----------

    def _replay(self, path: Path) -> None:
        if not path.exists():
            return
        restored = 0
        for line in path.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                logger.warning("jobs journal: skipping corrupt line")
                continue
            if rec.get("op") == "delete":
                self._jobs.pop(rec.get("job_id", ""), None)
                continue
            j = rec.get("job", {})
            if "job_id" not in j:
                continue
            self._jobs[j["job_id"]] = Job(
                job_id=j["job_id"],
                status=j.get("status", JobStatus.PENDING),
                progress=j.get("progress", 0),
                message=j.get("message", ""),
                results=j.get("results"),
                created_at=j.get("created_at", ""),
                model=j.get("model", ""),
            )
            restored += 1
        # Jobs interrupted mid-flight cannot resume (their in-process task
        # died with the server); fail them explicitly rather than leaving
        # clients polling forever. Every restored job also gets a
        # finished_at stamp of 0.0 ("long ago" on the fresh monotonic
        # clock): without it the eviction guard's `now` default made
        # restored terminal jobs permanently unevictable, growing the
        # registry past max_jobs forever.
        for job in self._jobs.values():
            if job.status in (JobStatus.PENDING, JobStatus.PROCESSING):
                job.status = JobStatus.ERROR
                job.message = "Error: job interrupted by server restart"
                job.progress = 0
            if job.status in (JobStatus.COMPLETED, JobStatus.ERROR):
                job.extra.setdefault("finished_at", 0.0)
        if self._jobs:
            logger.info("jobs journal: restored %d job(s)", len(self._jobs))

    def _compact(self, path: Path) -> None:
        """Rewrite the journal as one snapshot per surviving job."""
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for job in self._jobs.values():
                f.write(self._record(job))
        self._journal.close()
        os.replace(tmp, path)
        self._journal = self._open_journal(path)
        self._records = len(self._jobs)

    def _maybe_compact(self) -> None:
        """Bound journal growth on long-lived servers: with max_jobs
        eviction the registry stays bounded but the append-only file
        would otherwise accumulate dead put/delete records forever."""
        if self._journal is None or self._journal_path is None:
            return
        if self._records > max(1000, 4 * len(self._jobs)):
            try:
                self._compact(self._journal_path)
            except OSError as e:
                logger.warning("jobs journal compaction failed: %s", e)

    def _record(self, job: Job) -> str:
        return (
            json.dumps(
                {
                    "op": "put",
                    "job": {
                        "job_id": job.job_id,
                        "status": job.status,
                        "progress": job.progress,
                        "message": job.message,
                        "results": _slim_results(job.results),
                        "created_at": job.created_at,
                        "model": job.model,
                    },
                }
            )
            + "\n"
        )

    def _persist(self, job: Job) -> None:
        if self._journal is None:
            return
        try:
            self._journal.write(self._record(job))
            self._journal.flush()
            self._records += 1
            self._maybe_compact()
        # ValueError: write on a file closed by shutdown while a job task
        # finishes; neither failure may kill serving.
        except (OSError, ValueError) as e:
            logger.warning("jobs journal write failed: %s", e)

    # ---------- registry API ----------

    async def create(self, *, message: str = "Job queued", model: str = "") -> Job:
        job = Job(
            job_id=str(uuid.uuid4()),
            message=message,
            model=model,
            created_at=datetime.datetime.now().isoformat(),
        )
        async with self._lock:
            self._jobs[job.job_id] = job
            self._persist(job)
            self._evict_locked()
        return job

    def _journal_delete(self, job_id: str) -> None:
        if self._journal is None:
            return
        try:
            self._journal.write(
                json.dumps({"op": "delete", "job_id": job_id}) + "\n"
            )
            self._journal.flush()
            self._records += 1
            self._maybe_compact()
        except (OSError, ValueError) as e:
            logger.warning("jobs journal write failed: %s", e)

    def _evict_locked(self) -> None:
        if self._max_jobs is None or len(self._jobs) <= self._max_jobs:
            return
        import time as _time

        now = _time.monotonic()
        # Longest-finished first; never within the grace window (a job
        # must not vanish between completing and the client's next poll).
        evictable = sorted(
            (
                j for j in self._jobs.values()
                if j.status in (JobStatus.COMPLETED, JobStatus.ERROR)
                and now - j.extra.get("finished_at", now) > self.EVICT_GRACE_S
            ),
            key=lambda j: j.extra.get("finished_at", 0.0),
        )
        excess = len(self._jobs) - self._max_jobs
        for job in evictable[:excess]:
            self._jobs.pop(job.job_id, None)
            self._journal_delete(job.job_id)
            if self._on_evict is not None:
                try:
                    self._on_evict(job)
                except Exception as e:  # noqa: BLE001
                    logger.warning("on_evict failed for %s: %s", job.job_id, e)

    async def update(
        self,
        job_id: str,
        *,
        status: str | None = None,
        progress: int | None = None,
        message: str | None = None,
        results: Any = None,
    ) -> None:
        async with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                # Job deleted while its task was mid-flight (DELETE /jobs
                # during processing) — drop the update instead of blowing
                # up the fire-and-forget task.
                logger.info("update for deleted job %s ignored", job_id)
                return
            if status is not None:
                job.status = status
            if progress is not None:
                job.progress = progress
            if message is not None:
                job.message = message
            if results is not None:
                job.results = results
            if status in (JobStatus.COMPLETED, JobStatus.ERROR):
                import time as _time

                job.extra["finished_at"] = _time.monotonic()
                self._persist(job)
                self._evict_locked()
            self._signal(job)

    # ---------- long-poll support (beyond-reference: the reference's
    # frontend polls GET /status at a fixed 1.5 s, App.jsx:1012; a
    # ``wait_ms`` query param lets clients block on the NEXT state
    # change instead, removing poll-granularity latency) ----------

    @staticmethod
    def _signal(job: Job) -> None:
        """Wake every coroutine blocked in :meth:`wait_change`.

        The event is consumed (popped) on signal: each state transition
        gets a fresh event, so a waiter that re-arms after waking sees
        the *next* transition, never a stale set() from this one. Lives
        in ``extra`` — like ``_status_body``, never journaled.
        """
        ev = job.extra.pop("_changed", None)
        if ev is not None:
            ev.set()

    async def wait_change(self, job_id: str, wait_ms: float) -> None:
        """Block until the job's state next changes (any field), it is
        deleted, or ``wait_ms`` elapses — whichever is first. Returns
        immediately for unknown or already-terminal jobs. Callers must
        re-``get()`` the job afterwards (it may have been deleted).
        """
        job = self._jobs.get(job_id)
        if job is None or job.status in (JobStatus.COMPLETED, JobStatus.ERROR):
            return
        ev = job.extra.get("_changed")
        if ev is None:
            ev = asyncio.Event()
            job.extra["_changed"] = ev
        # No await between the status check above and wait() below, so a
        # transition cannot slip through unobserved (single event loop).
        try:
            await asyncio.wait_for(ev.wait(), wait_ms / 1000.0)
        except asyncio.TimeoutError:
            pass

    async def status_for(self, job_id: str, wait_raw: str | None) -> Job:
        """Endpoint half of long-poll: resolve a /status lookup.

        ``wait_raw`` is the request's ``wait_ms`` query value (None when
        absent — classic instant-poll semantics, the reference contract,
        backend/app.py:642-647). When present and positive, blocks via
        :meth:`wait_change` (capped at 30 s so a dead client cannot pin
        a connection), then re-resolves. Raises 404/400 as HTTPError.
        """
        from image_to_pointcloud_tpu_torch.serve.http import HTTPError

        job = self._jobs.get(job_id)
        if job is None:
            raise HTTPError(404, "Job not found")
        if wait_raw is not None:
            try:
                wait_ms = float(wait_raw)
            except ValueError:
                raise HTTPError(400, "wait_ms must be a number") from None
            wait_ms = min(max(wait_ms, 0.0), 30_000.0)
            if wait_ms > 0:
                await self.wait_change(job_id, wait_ms)
                job = self._jobs.get(job_id)
                if job is None:
                    raise HTTPError(404, "Job not found")
        return job

    def get(self, job_id: str) -> Job | None:
        return self._jobs.get(job_id)

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs

    def __len__(self) -> int:
        return len(self._jobs)

    async def delete(self, job_id: str) -> bool:
        async with self._lock:
            job = self._jobs.pop(job_id, None)
            if job is not None:
                self._journal_delete(job_id)
                # Wake long-pollers so they re-check and 404 instead of
                # sleeping out their full wait on a job that is gone.
                self._signal(job)
            return job is not None

    def list(self, status: str | None = None) -> list[Job]:
        return [
            j for j in self._jobs.values() if status is None or j.status == status
        ]

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None
