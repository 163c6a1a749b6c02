"""One typed configuration tree for the whole framework.

The reference scatters its configuration across hardcoded constants,
pydantic defaults, FastAPI parameter defaults, compose env vars, and
React state (SURVEY.md §5 "config/flag system") — with at least one
documented mismatch (frontend depthScale 15 vs backend 10.0,
frontend/src/App.jsx:24 vs backend/app.py:54). Here every knob lives in
one dataclass tree with the reference's defaults, loadable from JSON or
environment variables (``IPC_TPU_*``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

__all__ = ["ProcessingDefaults", "V2Defaults", "ServiceConfig", "load_config"]


@dataclasses.dataclass(frozen=True)
class ProcessingDefaults:
    """v1 request defaults (reference backend/app.py:47-56, 609-620)."""

    model: str = "depth-anything-v2"
    output_format: str = "las"
    point_density: str = "medium"
    coordinate_system: str = "WGS84"
    invert_depth: bool = True
    depth_scale: float = 10.0
    smooth_depth: bool = False
    smooth_ksize: int = 5
    fov: float = 60.0  # accepted-but-dropped by the reference (quirk 1)


@dataclasses.dataclass(frozen=True)
class V2Defaults:
    """v2 Form defaults + clamp ranges (reference backend/main.py:206-267)."""

    texture_resolution: int = 1024
    texture_resolution_range: tuple[int, int] = (512, 2048)
    guidance_scale: float = 3.0
    guidance_scale_range: tuple[float, float] = (1.0, 10.0)
    foreground_ratio: float = 1.3
    foreground_ratio_range: tuple[float, float] = (1.0, 2.0)
    target_count: int = 2000
    target_count_range: tuple[int, int] = (100, 20000)
    remove_background: bool = True
    remesh_option: str = "none"
    max_pixels: int = 4096 * 4096  # hard reject (backend/main.py:249)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    output_dir: str = "outputs"
    checkpoint_dir: str | None = None
    max_image_dim: int = 3072  # backend/app.py:43
    depth_preview_max: int = 2048  # backend/app.py:44
    max_file_size: int = 50 * 1024 * 1024  # backend/app.py:45
    max_preview_points: int = 20000  # backend/app.py:496
    mesh_preview_tris: int = 20000  # backend/app.py:516
    honor_fov: bool = False  # bug-compatible default (SURVEY.md §8 quirk 1)
    # v1 mesh_ply reconstruction: "grid" = exact depth-grid triangulation
    # (default; PARITY.md deviation 2), "poisson" = the reference's
    # actual algorithm (Poisson depth=8 + bbox crop, backend/app.py:
    # 297-301), "bpa" = ball-pivoting (backend/app.py:285-294).
    mesh_method: str = "grid"
    # Hybrid JPEG ingest: large JPEGs (>~3510 px max dim, i.e.
    # the ones the reference immediately downscales) entropy-decode on
    # the host and dequant/IDCT/upsample/color on the device at k/8
    # scale (native/src/jpegdec.cpp + ops/jpeg.py). Cuts the H2D
    # payload and host decode CPU several-fold for big photos; off by
    # default for byte-level decode parity (PARITY.md deviation).
    jpeg_device_decode: bool = False
    # Lazy artifact export: /process completes without writing the
    # point-cloud file; the bytes are packed and written on the first
    # GET /download/{id} instead. The v1 contract only promises the
    # file exists when fetched (backend/app.py:681-700), and most jobs'
    # artifacts are never downloaded (the frontend renders the inline
    # preview; downloads are user-initiated, App.jsx:1036-1044).
    # Bounded RAM: pending clouds above lazy_export_max_bytes spill to
    # disk oldest-first. PARITY.md deviation 11.
    lazy_export: bool = True
    lazy_export_max_bytes: int = 256 * 1024 * 1024
    batch_window_ms: float = 5.0
    # Micro-batch cap: batch-16 halves per-image device+transfer cost
    # vs batch-8 on the measured chip (bench.py batch sweep); buckets
    # warmed at startup are the powers of two up to this.
    max_batch: int = 16
    durable_jobs: bool = True  # JSONL job journal (beyond reference)
    max_jobs: int | None = None  # retention cap; None = reference parity
    # (keep every job forever, SURVEY.md §8 quirk 8)
    serve_ui: bool = False  # mount frontend/ at /ui
    mesh: str | None = None  # 'auto' or 'data=N,model=M[,seq=S]'
    warmup: str | None = None  # pre-compile sizes, e.g. '518x518'
    log_json: bool = False  # JSON-lines structured logging
    cors_origin_v1: str = "*"  # backend/app.py:32
    cors_origin_v2: str = "http://localhost:3000"  # backend/main.py:33
    defaults: ProcessingDefaults = ProcessingDefaults()
    v2: V2Defaults = V2Defaults()


def _coerce(value: str, field_type: str) -> Any:
    """Parse a string per the DECLARED field type (the annotation text;
    ``from __future__ import annotations`` keeps them strings).

    Typing by the default value's runtime type would mis-coerce every
    ``str | None`` field whose value happens to look numeric —
    IPC_TPU_WARMUP=518 must stay the string "518", not become int 518
    and crash at ``.split`` in serve/__main__.py."""
    if "bool" in field_type:
        return value.lower() in ("1", "true", "yes", "on")
    if "int" in field_type:
        return int(value)
    if "float" in field_type:
        return float(value)
    return value


def _coerce_nested(cls, values: dict) -> dict:
    """Apply the same string coercion to a nested subtree's values that
    top-level values get (a JSON {"defaults": {"depth_scale": "12"}}
    must not smuggle a str)."""
    types = {f.name: str(f.type) for f in dataclasses.fields(cls)}
    out = {}
    for k, v in values.items():
        if k not in types:
            raise ValueError(
                f"Unknown {cls.__name__} config key: {k!r} "
                f"(known: {sorted(types)})"
            )
        if isinstance(v, list):
            v = tuple(v)
        out[k] = _coerce(v, types[k]) if isinstance(v, str) else v
    return out


def load_config(
    path: str | None = None, env: dict[str, str] | None = None
) -> ServiceConfig:
    """Build a ServiceConfig from defaults ← JSON file ← IPC_TPU_* env.

    Fail-fast: an explicitly-given but missing config file, unknown
    keys (top-level or nested), and unparsable values all raise here —
    not as a 500 deep inside job creation or a silently-default server.
    """
    env = dict(os.environ if env is None else env)
    data: dict[str, Any] = {}
    if path:
        # The operator named this file; a typo'd path must not silently
        # start the server on defaults.
        data.update(json.loads(open(path).read()))

    cfg = ServiceConfig()
    known = {f.name for f in dataclasses.fields(ServiceConfig)}
    # "_"-prefixed keys are comments (docs/config.example.json).
    unknown = {k for k in data if k not in known and not k.startswith("_")}
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    if unknown:
        raise ValueError(
            f"Unknown config key(s): {sorted(unknown)} (known: {sorted(known)})"
        )
    top: dict[str, Any] = {}
    for f in dataclasses.fields(ServiceConfig):
        if f.name in ("defaults", "v2"):
            continue
        ftype = str(f.type)
        if f.name in data:
            v = data[f.name]
            # JSON values get the same coercion as env strings: a config
            # file {"port": "8000"} must not smuggle a str port that
            # crashes at socket bind instead of here.
            top[f.name] = _coerce(v, ftype) if isinstance(v, str) else v
        env_key = "IPC_TPU_" + f.name.upper()
        if env_key in env:
            top[f.name] = _coerce(env[env_key], ftype)

    defaults = ProcessingDefaults(
        **_coerce_nested(ProcessingDefaults, data.get("defaults", {}))
    )
    v2 = V2Defaults(**_coerce_nested(V2Defaults, data.get("v2", {})))
    return dataclasses.replace(cfg, defaults=defaults, v2=v2, **top)
