"""First-party asyncio HTTP/1.1 server — the framework's serving runtime.

The reference rides FastAPI/uvicorn (backend/app.py:27, 753); this
framework ships its own minimal server so the runtime has zero web-stack
dependencies: an asyncio protocol loop, request parsing (headers, query
strings, multipart/form-data uploads), path-template routing
(``/status/{job_id}``), CORS, JSON / bytes / file responses with the
same error shape FastAPI produces (``{"detail": ...}``) so the reference
frontend works unmodified against it.

Deliberately small: HTTP/1.1 with Content-Length bodies (the only thing
the reference contract needs), keep-alive, no TLS (terminate upstream).
"""

from __future__ import annotations

import asyncio
import json
import mimetypes
import re
import time
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Awaitable, Callable

from image_to_pointcloud_tpu_torch.serve import metrics

__all__ = [
    "Request",
    "Response",
    "HTTPError",
    "Router",
    "HttpServer",
    "json_response",
    "file_response",
]

MAX_BODY = 200 * 1024 * 1024  # hard transport cap; app enforces 50MB itself


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclass
class UploadFile:
    filename: str
    content_type: str
    data: bytes


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    path_params: dict[str, str] = field(default_factory=dict)

    _form: dict[str, str] | None = None
    _files: dict[str, UploadFile] | None = None

    def _parse_multipart(self) -> None:
        if self._form is not None:
            return
        self._form, self._files = {}, {}
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            self._form = {
                k: v[0]
                for k, v in urllib.parse.parse_qs(
                    self.body.decode("utf-8", "replace")
                ).items()
            }
            return
        m = re.search(r'boundary="?([^";,]+)"?', ctype)
        if not m:
            return
        boundary = b"--" + m.group(1).encode()
        for part in self.body.split(boundary)[1:-1]:
            # Remove exactly the one \r\n framing pair on each side —
            # bytes.strip would eat every trailing 0x0D/0x0A and corrupt
            # uploads whose content genuinely ends in newline bytes.
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" in part:
                raw_head, content = part.split(b"\r\n\r\n", 1)
            else:
                raw_head, content = part, b""
            head: dict[str, str] = {}
            for line in raw_head.decode("utf-8", "replace").split("\r\n"):
                if ":" in line:
                    k, v = line.split(":", 1)
                    head[k.strip().lower()] = v.strip()
            disp = head.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            if file_m:
                self._files[name] = UploadFile(
                    filename=file_m.group(1),
                    content_type=head.get("content-type", "application/octet-stream"),
                    data=content,
                )
            else:
                self._form[name] = content.decode("utf-8", "replace")

    @property
    def form(self) -> dict[str, str]:
        self._parse_multipart()
        return self._form or {}

    @property
    def files(self) -> dict[str, UploadFile]:
        self._parse_multipart()
        return self._files or {}

    def json(self) -> Any:
        return json.loads(self.body)


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def encode(self, cors_origin: str = "*") -> bytes:
        reason = {
            200: "OK", 204: "No Content", 308: "Permanent Redirect",
            400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 411: "Length Required",
            413: "Payload Too Large",
            431: "Request Header Fields Too Large",
            422: "Unprocessable Entity",
            500: "Internal Server Error", 503: "Service Unavailable",
        }.get(self.status, "OK")
        head = [f"HTTP/1.1 {self.status} {reason}"]
        base = {
            "content-length": str(len(self.body)),
            "access-control-allow-origin": cors_origin,
            "access-control-allow-methods": "*",
            "access-control-allow-headers": "*",
            "access-control-allow-credentials": "true",
        }
        base.update({k.lower(): v for k, v in self.headers.items()})
        head += [f"{k}: {v}" for k, v in base.items()]
        return ("\r\n".join(head) + "\r\n\r\n").encode() + self.body

    def encode_head(self, cors_origin: str = "*") -> bytes:
        """Status line + headers only — the transport writes the body
        buffer separately, avoiding a second full copy of large
        artifact responses."""
        full = self.encode(cors_origin)
        return full[: len(full) - len(self.body)] if self.body else full


def json_response(obj: Any, status: int = 200) -> Response:
    from image_to_pointcloud_tpu_torch.serve.rawjson import dumps_raw

    return Response(
        status=status,
        headers={"content-type": "application/json"},
        body=dumps_raw(obj),
    )


async def file_response(
    path: str | Path,
    media_type: str | None = None,
    filename: str | None = None,
    inline: bool = False,
) -> Response:
    p = Path(path)
    if not p.exists():
        raise HTTPError(404, "File not found")
    if media_type is None:
        media_type = mimetypes.guess_type(str(p))[0] or "application/octet-stream"
    headers = {"content-type": media_type}
    if not inline:
        name = filename or p.name
        headers["content-disposition"] = f'attachment; filename="{name}"'
    # Executor read: a multi-hundred-MB artifact read on the event loop
    # would head-of-line block every connection on the 1-core host.
    body = await asyncio.get_running_loop().run_in_executor(None, p.read_bytes)
    return Response(headers=headers, body=body)


# Compress large text bodies when the client allows it: the v1 /status
# payload carries the ≤20k-point inline preview (reference
# backend/app.py:496-506) — multi-MB of JSON per 1.5 s poll — which
# gzips ~5×.
GZIP_MIN_BYTES = 64 * 1024
_GZIP_TYPES = ("application/json", "text/")


def _accepts_gzip(accept_encoding: str) -> bool:
    """RFC 9110 semantics: ``gzip;q=0`` is an explicit refusal, and an
    exact ``gzip`` member takes precedence over ``*`` regardless of
    order (e.g. ``*;q=0, gzip`` accepts gzip)."""
    gzip_q = star_q = None
    for token in accept_encoding.split(","):
        parts = [p.strip() for p in token.split(";")]
        if parts[0] not in ("gzip", "*"):
            continue
        q = 1.0
        for p in parts[1:]:
            if p.startswith("q="):
                try:
                    q = float(p[2:])
                except ValueError:
                    q = 0.0
        if parts[0] == "gzip":
            gzip_q = q
        else:
            star_q = q
    q = gzip_q if gzip_q is not None else star_q
    return q is not None and q > 0.0


async def _maybe_gzip(req: Request, resp: Response) -> None:
    if len(resp.body) < GZIP_MIN_BYTES:
        return
    if not _accepts_gzip(req.headers.get("accept-encoding", "")):
        return
    ctype = resp.headers.get("content-type", "")
    if not any(ctype.startswith(t) for t in _GZIP_TYPES):
        return
    if "content-encoding" in {k.lower() for k in resp.headers}:
        return
    import gzip as _gzip

    # Off the event loop: multi-MB /status bodies on a 1-core host would
    # otherwise head-of-line block every other connection.
    resp.body = await asyncio.get_running_loop().run_in_executor(
        None, lambda: _gzip.compress(resp.body, compresslevel=1)
    )
    resp.headers["content-encoding"] = "gzip"
    resp.headers["vary"] = "accept-encoding"


Handler = Callable[[Request], Awaitable[Response]]


class Router:
    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._static: list[tuple[str, Path]] = []

    def route(self, method: str, template: str) -> Callable[[Handler], Handler]:
        pattern = re.compile(
            "^"
            + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", template)
            + "$"
        )

        def deco(fn: Handler) -> Handler:
            self._routes.append((method.upper(), pattern, fn))
            return fn

        return deco

    def get(self, t: str):
        return self.route("GET", t)

    def post(self, t: str):
        return self.route("POST", t)

    def delete(self, t: str):
        return self.route("DELETE", t)

    def mount_static(
        self, prefix: str, directory: str | Path, prepare=None
    ) -> None:
        """Serve files under ``directory`` at ``prefix``. ``prepare``,
        if given, is awaited with the relative path before the existence
        check — a hook for lazily-materialized artifacts (app_v1's
        deferred exports)."""
        self._static.append((prefix.rstrip("/") + "/", Path(directory), prepare))

    async def dispatch(self, req: Request) -> Response:
        if req.method == "OPTIONS":  # CORS preflight
            return Response(status=204)
        for prefix, directory, prepare in self._static:
            stripped = prefix.rstrip("/")
            if req.method == "GET" and req.path == stripped:
                # Redirect so relative asset URLs in index.html resolve
                # under the mount (/ui → /ui/).
                return Response(
                    status=308, headers={"location": prefix}, body=b""
                )
            if req.method == "GET" and req.path.startswith(prefix):
                rel = urllib.parse.unquote(req.path[len(prefix):])
                # Hidden files (e.g. the .jobs.jsonl journal living in the
                # outputs dir) are not servable artifacts.
                if any(part.startswith(".") for part in rel.split("/") if part):
                    raise HTTPError(404, "Not found")
                target = (directory / rel).resolve()
                # Path.is_relative_to, not str.startswith: a sibling dir
                # sharing the mount dir's name prefix (outputs vs
                # outputs-archive) must not pass containment.
                if not target.is_relative_to(directory.resolve()):
                    raise HTTPError(404, "Not found")
                if prepare is not None:
                    await prepare(rel)
                if rel == "" or target.is_dir():
                    target = target / "index.html"
                # UI assets render inline; anything else (e.g. /outputs
                # artifacts, reference main.py:397) downloads as before.
                inline = target.suffix in {
                    ".html", ".js", ".css", ".png", ".jpg", ".svg", ".ico",
                    ".json", ".map",
                }
                return await file_response(target, inline=inline)
        allowed_other_method = False
        for method, pattern, fn in self._routes:
            m = pattern.match(req.path)
            if m:
                if method != req.method:
                    allowed_other_method = True
                    continue
                req.path_params = m.groupdict()
                return await fn(req)
        if allowed_other_method:
            raise HTTPError(405, "Method Not Allowed")
        raise HTTPError(404, "Not Found")


class HttpServer:
    """asyncio server binding a Router; lifecycle mirrors uvicorn's."""

    def __init__(
        self,
        router: Router,
        host: str = "0.0.0.0",
        port: int = 8000,
        cors_origin: str = "*",
    ):
        self.router = router
        self.host = host
        self.port = port
        self.cors_origin = cors_origin
        self._server: asyncio.AbstractServer | None = None

    async def _read_request(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Request | None:
        try:
            # The idle timeout covers waiting for the next request's
            # headers only; a slow body upload that is actively sending
            # may take as long as it needs.
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), self.IDLE_TIMEOUT_S
            )
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        except asyncio.LimitOverrunError:
            # Headers exceed the StreamReader limit (~64 KiB): answer
            # properly instead of a bare reset.
            raise HTTPError(431, "Request header fields too large") from None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _ = lines[0].split(" ", 2)
        except ValueError:
            raise HTTPError(400, "Malformed request line") from None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            if line[0] in " \t":
                # Obsolete line folding (RFC 9112 §5.2): proxies disagree
                # on whether the folded text belongs to the previous
                # field — a classic smuggling ambiguity. Refuse.
                raise HTTPError(400, "Obsolete header line folding")
            if ":" not in line:
                raise HTTPError(400, "Malformed header line")
            k, v = line.split(":", 1)
            if k != k.rstrip():
                # RFC 9112 §5.1: no whitespace between field name and
                # colon ("Content-Length : 5" is the canonical
                # request-smuggling probe). Refuse rather than normalize.
                raise HTTPError(400, "Whitespace before header colon")
            key = k.strip().lower()
            if key == "content-length" and headers.get(key, v.strip()) != v.strip():
                # Two different Content-Length values desync any
                # intermediary that picks the other one (RFC 9110 §8.6).
                raise HTTPError(400, "Conflicting Content-Length headers")
            headers[key] = v.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # Treating a chunked body as zero-length would leave the
            # chunk stream in the buffer to be misparsed as pipelined
            # requests (desync/smuggling primitive). Refuse and close.
            raise HTTPError(
                411, "Chunked transfer encoding not supported; "
                "send Content-Length"
            )
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HTTPError(400, "Invalid Content-Length") from None
        if length < 0:
            raise HTTPError(400, "Invalid Content-Length")
        if length > MAX_BODY:
            raise HTTPError(413, "Body too large")
        if length and headers.get("expect", "").lower() == "100-continue":
            # Standards-following upload clients (curl -F with any body
            # >1 KB) wait for the interim response before sending the
            # body — not answering adds a flat ~1 s to every upload.
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if length:
            # Stall-aware body read: a slow-but-active upload may take
            # as long as it needs (each chunk resets the clock), but a
            # client that declared a length and then stopped sending is
            # reaped — otherwise stalled bodies hold connections forever
            # (slowloris via body; the header path is covered by
            # IDLE_TIMEOUT_S).
            chunks = []
            got = 0
            while got < length:
                try:
                    chunk = await asyncio.wait_for(
                        reader.read(min(1 << 20, length - got)),
                        self.BODY_STALL_TIMEOUT_S,
                    )
                except asyncio.TimeoutError:
                    raise HTTPError(
                        408, "Request body timed out"
                    ) from None
                if not chunk:
                    return None  # client closed mid-body
                chunks.append(chunk)
                got += len(chunk)
            body = b"".join(chunks)
        else:
            body = b""
        parsed = urllib.parse.urlsplit(target)
        query = {
            k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        return Request(
            method=method.upper(),
            path=parsed.path,
            query=query,
            headers=headers,
            body=body,
        )

    # Idle keep-alive connections are reaped when no request *headers*
    # arrive for this long (slowloris guard); an in-progress body upload
    # is not subject to it.
    IDLE_TIMEOUT_S = 300.0
    # Max seconds between body chunks before a declared-length upload is
    # considered stalled (408). Resets on every received chunk, so
    # arbitrarily slow uploads survive as long as bytes keep flowing.
    BODY_STALL_TIMEOUT_S = 60.0

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                try:
                    req = await self._read_request(reader, writer)
                except asyncio.TimeoutError:
                    break
                except HTTPError as e:
                    # e.g. 413 body-too-large: answer properly, then close
                    # (the oversized body was never drained).
                    writer.write(
                        json_response({"detail": e.detail}, e.status).encode(
                            self.cors_origin
                        )
                    )
                    await writer.drain()
                    break
                if req is None:
                    break
                t0 = time.perf_counter()
                try:
                    resp = await self.router.dispatch(req)
                except HTTPError as e:
                    resp = json_response({"detail": e.detail}, e.status)
                except Exception as e:  # noqa: BLE001
                    resp = json_response({"detail": f"Internal error: {e}"}, 500)
                pc = metrics.path_class(req.path)
                metrics.HTTP_REQUESTS.inc(
                    method=req.method, path=pc, status=str(resp.status)
                )
                metrics.HTTP_LATENCY.observe(time.perf_counter() - t0, path=pc)
                await _maybe_gzip(req, resp)
                # Head and body written separately: one less full copy of
                # large artifact bodies than head+body concatenation.
                writer.write(resp.encode_head(self.cors_origin))
                if resp.body:
                    writer.write(resp.body)
                await writer.drain()
                if req.headers.get("connection", "").lower() == "close":
                    break
        except ConnectionError:
            # Client went away mid-write (browsers abort /status polls
            # constantly) — routine, not a task-level traceback.
            pass
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger(__name__).exception("connection handler failed")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
