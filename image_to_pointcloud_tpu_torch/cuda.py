"""Build, load and count the port's hand-written CUDA kernels.

Every source under ``csrc/`` is compiled at first use by ``nvcc`` for
``sm_90a``, one ``nvcc`` a source, all started together, and linked into
one shared library with a plain C interface, which ``ctypes`` loads. A
build takes seconds (no PyTorch headers). The
library's file name carries a hash of the sources and flags, so an edited
source never loads a stale build; the build writes to a temporary name
and renames, so two processes racing the same build both end with a
whole file. A lock serializes the build inside one process (the server's
executor threads can reach the first launch together).

Each kernel has a :class:`Kernel` counter that its wrapper increments
where, and only where, it launches the kernel. The wrappers count when
they enqueue; inside a CUDA graph capture (:func:`recording_launches`)
nothing is launched, so the enqueue is recorded instead, and
:func:`replayed` adds the recorded launches on each replay of the graph:
a counter is the number of launches on the card either way.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR",
    "DEPTHNORM",
    "FLASH_ATTENTION",
    "GRID_KNN",
    "KERNELS",
    "Kernel",
    "UNPROJECT",
    "check",
    "library",
    "recording_launches",
    "replayed",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_attention.cu", "grid_knn.cu", "unproject.cu", "depthnorm.cu", "error.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)


# The launch record of the capture under way on this thread, if any.
_capture = threading.local()


class Kernel:
    """Launch counter of one hand-written kernel."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def count(self) -> None:
        """One launch enqueued: counted, or recorded by the capture under
        way on this thread (a capture launches nothing)."""
        record = getattr(_capture, "launches", None)
        if record is not None:
            record[self] = record.get(self, 0) + 1
            return
        self.add(1)

    def add(self, n: int) -> None:
        with self._lock:
            self.launches += n

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph is captured on this thread: yields a dict that
    collects the launches each :class:`Kernel` enqueues into the graph,
    counted on no counter. Pass it to :func:`replayed` on every replay."""
    outer = getattr(_capture, "launches", None)
    _capture.launches = record = {}
    try:
        yield record
    finally:
        _capture.launches = outer


def replayed(record: dict) -> None:
    """One replay of a captured graph: its recorded launches counted."""
    for kernel, n in record.items():
        kernel.add(n)


FLASH_ATTENTION = Kernel("flash_attention")
GRID_KNN = Kernel("grid_knn")
UNPROJECT = Kernel("unproject")
# One count a call: its four histogram launches and its elementwise one.
DEPTHNORM = Kernel("depthnorm")
KERNELS = (FLASH_ATTENTION, GRID_KNN, UNPROJECT, DEPTHNORM)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: RuntimeError | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from csrc/ at first use"
        )
    return found


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libipc_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{name}.o") for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [(n, p.returncode, log) for n, p, log in zip(SOURCES, procs, logs) if p.returncode]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode:
                failed = [("link", link.returncode, link.stderr)]
        so.with_suffix(".log").write_text("".join(logs))
        if failed:
            name, rc, log = failed[0]
            raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ipc_flash_attention.argtypes = [
        p, p, p, p, i, i, i, i, ctypes.POINTER(ll), ctypes.c_float, i, p,
    ]
    lib.ipc_flash_attention.restype = i
    lib.ipc_grid_knn.argtypes = [p, p, i, i, i, i, i, ll, ll, ll, p]
    lib.ipc_grid_knn.restype = i
    f = ctypes.c_float
    lib.ipc_unproject.argtypes = [
        p, p, i, p, p, i, i, i, i, f, f, f, ll, ll, ll, ll, ll, ll, ll, p,
    ]
    lib.ipc_unproject.restype = i
    lib.ipc_depthnorm_scratch_bytes.argtypes = [i]
    lib.ipc_depthnorm_scratch_bytes.restype = ll
    lib.ipc_depthnorm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, f, f, f, i, p]
    lib.ipc_depthnorm.restype = i
    lib.ipc_cuda_error_string.argtypes = [i]
    lib.ipc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first call. A
    build that failed raises its error again on every later call, without
    building again (the sources of a running process do not change)."""
    global _lib, _build_error
    with _lock:
        if _build_error is not None:
            raise _build_error
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except RuntimeError as e:
                _build_error = e
                raise
        return _lib


def check(err: int, kernel: Kernel) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        text = library().ipc_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {err} ({text})")
