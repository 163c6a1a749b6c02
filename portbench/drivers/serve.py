"""The serving driver: an open loop of independent users against the
port's v1 server, which runs in a child process (so that the load
generator shares no GIL with it).

Each request is due at its scheduled time: ``POST /process`` of a JPEG,
then ``GET /status/{id}?wait_ms=…`` until the job ends, then
``GET /download/{id}`` to the last byte of its point cloud; its latency
runs from when it was due. The arrivals are a fixed set of exponential
gaps at the traffic's rate (the quantiles of the distribution, so every
seed sends the same number of requests over the same time), shuffled by
the seed; the uploads are drawn from ``distinct_images`` JPEGs made from
the seed. After the window it waits up to ``late_s`` for the requests
still out; one that fails, ends in ``error`` or never ends counts as
failed.
"""

from __future__ import annotations

import asyncio
import json
import re
import resource
import shutil
import signal
import statistics
import subprocess
import sys
import time
import urllib.parse

import numpy as np

from portbench import synth
from portbench.tracing import parse_prometheus

_STATUS = re.compile(rb'"status"\s*:\s*"([a-z]+)"')


class _Client:
    def __init__(self, port: int):
        self.port = port

    async def call(self, method: str, path: str, body: bytes = b"", ctype: str | None = None):
        """One HTTP/1.1 exchange on a fresh connection → (status, body)."""
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port)
        try:
            head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", f"Content-Length: {len(body)}",
                    "Connection: close"]
            if ctype:
                head.append(f"Content-Type: {ctype}")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            length = None
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                if k.strip().lower() == "content-length":
                    length = int(v.strip())
            data = await (reader.readexactly(length) if length is not None else reader.read())
            return status, data
        finally:
            writer.close()


def _multipart(data: bytes, boundary: str = "portbench0boundary") -> tuple[bytes, str]:
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"upload.jpg\"\r\n"
            f"Content-Type: image/jpeg\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send offsets (s) of ``round(rate·seconds)`` requests: the exponential
    gaps' quantiles, in an order drawn from the seed."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng([seed, 3]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def _start_child(ctx: dict) -> subprocess.Popen:
    out_dir = ctx["run_dir"] / "serve_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    params = {"config": str(ctx["cfg_path"]), "seed": ctx["seed"], "out_dir": str(out_dir),
              "server": ctx["traffic"]["server"], "device": ctx["device"]}
    with open(ctx["run_dir"] / "serve_child.log", "wb") as log:
        return subprocess.Popen([sys.executable, "-m", "portbench.drivers.serve_child", json.dumps(params)],
                                cwd=ctx["root"], stdout=subprocess.PIPE, stderr=log, env=ctx["env"])


def _stop_child(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()


def _raise_open_files() -> None:
    """A backlog of requests holds a socket each on both sides: the soft
    limit of open files up to the hard one (the server inherits it)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))


def run(ctx: dict) -> dict:
    tr, seed, log = ctx["traffic"], ctx["seed"], ctx["log"]
    _raise_open_files()
    offsets = arrivals(tr["rate_per_s"], ctx["seconds"], seed)
    rng = np.random.default_rng([seed, 4])
    which = rng.integers(0, tr["distinct_images"], len(offsets))
    sample = set(rng.choice(len(offsets), size=min(tr["sample"], len(offsets)), replace=False).tolist())
    query = urllib.parse.urlencode({**tr["query"], "model": ctx["cfg"]["preset"]})

    # The server loads while the uploads are made.
    proc = _start_child(ctx)
    try:
        h, w = tr["upload_hw"]
        images = synth.frames(seed, tr["distinct_images"], h, w)
        jpegs = [synth.jpeg(img, tr["jpeg_quality"]) for img in images]
        line = proc.stdout.readline()
        if not line:
            tail = (ctx["run_dir"] / "serve_child.log").read_bytes()[-4000:].decode(errors="replace")
            raise RuntimeError(f"the server exited during set-up:\n{tail}")
        ready = json.loads(line)
        log(f"first-run build {ready['build_s']:.3f} s (0 where the checkout had it); "
            f"server warmup {ready['warmup_s']:.3f} s")
        rec = asyncio.run(_window(ctx, _Client(ready["port"]), offsets, which, jpegs, sample, query))
    finally:
        _stop_child(proc)
        # The point clouds the server wrote were read back over HTTP.
        for f in (ctx["run_dir"] / "serve_out").glob("*.ply"):
            f.unlink()
    rec["build_s"] = ready["build_s"]
    # The reference reads each upload as the server does: the JPEG decoded.
    ply = rec.pop("ply")
    decoded = {j: synth.decode(jpegs[j]) for j in {int(which[i]) for i in ply}}
    rec["sample"] = [(decoded[int(which[i])], ply[i]) for i in sorted(ply)]
    return rec


async def _window(ctx, client: _Client, offsets, which, jpegs, sample, query) -> dict:
    tr, log = ctx["traffic"], ctx["log"]
    seconds = ctx["seconds"]
    res: dict[int, dict] = {}
    ply: dict[int, bytes] = {}

    async def one(i: int, due: float, keep: "set | None") -> None:
        await asyncio.sleep(max(0.0, due - time.perf_counter()))
        r = res[i] = {"late_s": time.perf_counter() - due, "ok": False}
        try:
            body, ctype = _multipart(jpegs[which[i % len(which)]])
            st, data = await client.call("POST", f"/process?{query}", body, ctype)
            if st != 200:
                r["error"] = f"POST {st}"
                return
            job = json.loads(data)["job_id"]
            r["posted"] = time.perf_counter()
            while True:
                st, data = await client.call("GET", f"/status/{job}?wait_ms={tr['status_wait_ms']}")
                m = _STATUS.search(data[:400])
                if st != 200 or m is None:
                    r["error"] = f"status {st}"
                    return
                if m.group(1) in (b"completed", b"error"):
                    break
            if m.group(1) == b"error":
                r["error"] = "job error"
                return
            r["ended"] = time.perf_counter()
            st, data = await client.call("GET", f"/download/{job}")
            if st != 200:
                r["error"] = f"download {st}"
                return
            done = time.perf_counter()
            r.update(ok=True, job=job, latency_s=done - due, due=due, done=done)
            if keep is not None and i in keep:
                ply[i] = data
        except (OSError, ValueError, KeyError, asyncio.IncompleteReadError) as e:
            r["error"] = repr(e)

    # Warm-up, counted as set-up: the traffic's own requests for a few
    # seconds, so that the server's threads, codecs and lazy imports are
    # warm, and under --trace 1 a profile of it, so that the profiler's
    # first start (seconds of CUPTI set-up) falls here too.
    warm = arrivals(tr["rate_per_s"], tr["warmup_s"], ctx["seed"] + 1)
    if ctx["trace"]:
        await client.call("POST", "/profile/start")
    t_start = time.perf_counter() + 0.05
    await asyncio.gather(*(one(i, t_start + off, None) for i, off in enumerate(warm)))
    if ctx["trace"]:
        await client.call("POST", "/profile/stop")
    warm_failed = sum(1 for r in res.values() if not r.get("ok"))
    if warm_failed:
        log(f"warm-up: {warm_failed} of {len(warm)} requests failed")
    res.clear()
    _, m0 = await client.call("GET", "/metrics")
    t_start = time.perf_counter() + 0.05
    setup_s = t_start - ctx["t0"]

    async def profile() -> str | None:
        await asyncio.sleep(max(0.0, t_start + seconds - tr["trace_s"] - time.perf_counter()))
        await client.call("POST", "/profile/start")
        await asyncio.sleep(max(0.0, t_start + seconds - time.perf_counter()))
        st, data = await client.call("POST", "/profile/stop")
        return json.loads(data)["trace"] if st == 200 else None

    tasks = [asyncio.create_task(one(i, t_start + off, sample)) for i, off in enumerate(offsets)]
    prof = asyncio.create_task(profile()) if ctx["trace"] else None
    done, pending = await asyncio.wait(tasks, timeout=t_start + seconds + tr["late_s"] - time.perf_counter())
    for t in pending:
        t.cancel()
    trace_path = await prof if prof is not None else None
    t_end = time.perf_counter()
    _, m1 = await client.call("GET", "/metrics")
    timings = {}
    if ctx["trace"]:
        for i, r in res.items():
            if r.get("ok"):
                st, data = await client.call("GET", f"/timings/{r['job']}")
                if st == 200:
                    timings[i] = json.loads(data)["timings"]
    # Read once the window has closed: the server's peak and what it loaded.
    _, state = await client.call("GET", "/portbench/state")
    state = json.loads(state)

    ok = [r for r in res.values() if r.get("ok")]
    lat = [r["latency_s"] * 1e3 for r in ok]
    failed = len(offsets) - len(ok)
    errors = sorted({r.get("error", "never ended") for r in res.values() if not r.get("ok")}
                    | ({"never ended"} if len(res) < len(offsets) else set()))
    late = sorted(r["late_s"] for r in res.values())
    q = len(offsets) // 4 or 1
    by_due = sorted(ok, key=lambda r: r["due"])
    first_q = [r["latency_s"] * 1e3 for r in by_due[:q]]
    last_q = [r["latency_s"] * 1e3 for r in by_due[-q:]]
    log(f"requests: sent {len(res)} of {len(offsets)}, succeeded {len(ok)}, failed {failed}"
        + (f" ({'; '.join(errors)[:300]})" if errors else ""))
    if late:
        log(f"generator lateness: median {statistics.median(late) * 1e3:.3f} ms, "
            f"p99 {late[min(len(late) - 1, int(0.99 * len(late)))] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms")
    if first_q and last_q:
        log(f"backlog: median latency of the first quarter of arrivals {statistics.median(first_q):.3f} ms, "
            f"of the last {statistics.median(last_q):.3f} ms; all ended {t_end - t_start - seconds:.3f} s "
            f"after the window")
    if lat:
        srt = sorted(lat)
        tail = ", ".join(f"p{q} {srt[min(len(srt) - 1, int(q / 100 * len(srt)))]:.3f}" for q in (90, 95, 99))
        within = ", ".join(f"{ms} ms {100 * sum(1 for x in lat if x <= ms) / len(offsets):.2f}%"
                           for ms in (100, 150, 200, 250, 300, 400))
        phases = ", ".join(f"{k} {statistics.median((r[b] - r[a]) * 1e3 for r in ok):.3f}"
                           for k, a, b in (("post", "due", "posted"), ("job", "posted", "ended"),
                                           ("download", "ended", "done")))
        log(f"latency: median {statistics.median(lat):.3f}, {tail}, max {srt[-1]:.3f} ms; within {within}; "
            f"median phases (ms): {phases}")
    in_window = sum(1 for r in ok if r["done"] <= t_start + seconds)
    log(f"completed in the window: {in_window} ({in_window / seconds} req/s)")
    # What a knee sweep's test reads (portbench/knee.py).
    backlog = {"first_quarter_ms": statistics.median(first_q) if first_q else None,
               "last_quarter_ms": statistics.median(last_q) if last_q else None,
               "ended_after_s": t_end - t_start - seconds, "completed_per_s": in_window / seconds}
    return {
        "setup_s": setup_s,
        "window_s": seconds,
        "latencies_ms": lat,
        # Per deadline of the traffic's ``within_ms``: the share (%) of all
        # the window's requests whose point cloud was downloaded within it
        # of their due time; a failed request is not within any.
        "within_pct": {ms: 100 * sum(1 for x in lat if x <= ms) / len(offsets)
                       for ms in tr.get("within_ms", [])},
        "client_ms": {i: r["latency_s"] * 1e3 for i, r in res.items() if r.get("ok")},
        "attempted": len(offsets),
        "failed": failed,
        "memory_peak_bytes": state["peak_bytes"],
        "server_loaded": state["loaded"],
        "server_metrics": {"before": parse_prometheus(m0.decode()), "after": parse_prometheus(m1.decode())},
        "timings": timings,
        "trace_path": trace_path,
        "ply": ply,
        "backlog": backlog,
    }
