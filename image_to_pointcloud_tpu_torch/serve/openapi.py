"""OpenAPI 3 documents for both API generations.

The reference's FastAPI apps auto-serve ``/openapi.json`` (FastAPI adds
it to every app) and clients/tooling written against the reference may
introspect it. The first-party server has no schema generator, so the
documents are authored here to mirror the reference's contracts:

* v1 paths/parameters from backend/app.py:609-747 (8 query params on
  /process, ProcessingStatus response shape at app.py:58-63),
* v2 paths/Form fields + clamp ranges from backend/main.py:202-431.

Deliberately descriptive, not generative: the documents state what the
handlers already implement (serve/app_v1.py, serve/app_v2.py), and
tests/test_serve.py asserts the path sets stay in sync with the routers.
"""

from __future__ import annotations

__all__ = ["v1_openapi", "v2_openapi", "docs_html"]

_STATUS_SCHEMA = {
    "type": "object",
    "properties": {
        "job_id": {"type": "string"},
        "status": {
            "type": "string",
            "enum": ["pending", "processing", "completed", "error"],
        },
        "progress": {"type": "integer"},
        "message": {"type": "string"},
        "results": {"type": "object", "nullable": True},
    },
}


def _job_param():
    return {
        "name": "job_id",
        "in": "path",
        "required": True,
        "schema": {"type": "string"},
    }


def _wait_param():
    """Beyond-reference long-poll knob on GET /status (serve/jobs.py
    JobRegistry.status_for): block up to wait_ms for the next job state
    change instead of returning an instant snapshot."""
    return {
        "name": "wait_ms",
        "in": "query",
        "required": False,
        "schema": {"type": "number", "minimum": 0, "maximum": 30000},
        "description": (
            "Long-poll: hold the request until the job's state next "
            "changes or this many milliseconds pass (clamped to 30000). "
            "Omit for the reference's instant-snapshot behavior."
        ),
    }


def v1_openapi() -> dict:
    """Mirror of the reference v1 schema surface (backend/app.py)."""
    q = lambda name, schema, **kw: {  # noqa: E731
        "name": name, "in": "query", "required": False, "schema": schema, **kw
    }
    return {
        "openapi": "3.1.0",
        "info": {"title": "Image to Point Cloud API", "version": "1.0.0"},
        "paths": {
            "/process": {
                "post": {
                    "summary": "Process Image",
                    "description": (
                        "Multipart image upload → background depth → "
                        "point-cloud job. Settings are accepted as query "
                        "params (reference contract, backend/app.py:611-620) "
                        "AND as multipart form fields (PARITY.md "
                        "deviation 9 — the reference frontend sends form "
                        "fields the reference backend drops)."
                    ),
                    "parameters": [
                        q("model", {"type": "string", "default": "depth-anything-v2"}),
                        q("output_format", {"type": "string", "default": "las",
                                            "enum": ["ply", "las", "laz", "xyz", "mesh_ply"]}),
                        q("point_density", {"type": "string", "default": "medium",
                                            "enum": ["low", "medium", "high"]}),
                        q("coordinate_system", {"type": "string", "default": "WGS84"}),
                        q("gps_coords", {"type": "string", "nullable": True}),
                        q("invert_depth", {"type": "boolean", "default": True}),
                        q("depth_scale", {"type": "number", "default": 10.0}),
                        q("smooth_depth", {"type": "boolean", "default": False}),
                        q("fov", {"type": "number", "default": 60.0}),
                    ],
                    "requestBody": {
                        "content": {
                            "multipart/form-data": {
                                "schema": {
                                    "type": "object",
                                    "required": ["file"],
                                    "properties": {
                                        "file": {"type": "string", "format": "binary"}
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": '{"job_id", "status": "queued"}'},
                        "400": {"description": "File must be an image"},
                        "413": {"description": "File exceeds the 50 MB cap"},
                        "422": {"description": "Invalid parameter value"},
                    },
                }
            },
            "/status/{job_id}": {
                "get": {
                    "summary": "Get Status",
                    "parameters": [_job_param(), _wait_param()],
                    "responses": {
                        "200": {
                            "description": "Job state + results when completed",
                            "content": {"application/json": {"schema": _STATUS_SCHEMA}},
                        },
                        "400": {"description": "wait_ms not a number"},
                        "404": {"description": "Job not found"},
                    },
                }
            },
            "/download/{job_id}": {
                "get": {
                    "summary": "Download File",
                    "parameters": [_job_param()],
                    "responses": {
                        "200": {"description": "application/octet-stream artifact"},
                        "400": {"description": "Job not completed"},
                        "404": {"description": "Job/file not found"},
                    },
                }
            },
            "/models": {"get": {"summary": "List Models",
                                "responses": {"200": {"description": "Capability cards"}}}},
            "/health": {"get": {"summary": "Health Check",
                                "responses": {"200": {"description": "Service health"}}}},
        },
    }


def v2_openapi() -> dict:
    """Mirror of the reference v2 schema surface (backend/main.py)."""
    return {
        "openapi": "3.1.0",
        "info": {"title": "SPAR3D Image to 3D API", "version": "2.0.0"},
        "paths": {
            "/": {"get": {"summary": "Service Info",
                          "responses": {"200": {"description": "API metadata"}}}},
            "/models": {"get": {"summary": "List Models",
                                "responses": {"200": {"description": "Capability card"}}}},
            "/process": {
                "post": {
                    "summary": "Generate 3D Asset",
                    "requestBody": {
                        "content": {
                            "multipart/form-data": {
                                "schema": {
                                    "type": "object",
                                    "required": ["file"],
                                    "properties": {
                                        "file": {"type": "string", "format": "binary"},
                                        "model": {"type": "string", "default": "depth3d"},
                                        "output_format": {"type": "string", "default": "glb"},
                                        "texture_resolution": {
                                            "type": "integer", "default": 1024,
                                            "minimum": 512, "maximum": 2048,
                                        },
                                        "guidance_scale": {
                                            "type": "number", "default": 3.0,
                                            "minimum": 1.0, "maximum": 10.0,
                                        },
                                        "seed": {"type": "integer", "nullable": True},
                                        "remove_background": {"type": "boolean", "default": True},
                                        "foreground_ratio": {
                                            "type": "number", "default": 1.3,
                                            "minimum": 1.0, "maximum": 2.0,
                                        },
                                        "remesh_option": {"type": "string", "default": "none"},
                                        "target_count": {
                                            "type": "integer", "default": 2000,
                                            "minimum": 100, "maximum": 20000,
                                        },
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": '{"job_id", "status", "estimated_time"}'},
                        "400": {"description": "Invalid image"},
                        "422": {"description": "Invalid form value"},
                        "503": {"description": "Model not loaded"},
                    },
                }
            },
            "/status/{job_id}": {
                "get": {"summary": "Get Status",
                        "parameters": [_job_param(), _wait_param()],
                        "responses": {"200": {"description": "Job state"},
                                      "400": {"description": "wait_ms not a number"},
                                      "404": {"description": "Job not found"}}}
            },
            "/download/{job_id}/{filename}": {
                "get": {
                    "summary": "Download Artifact",
                    "parameters": [
                        _job_param(),
                        {"name": "filename", "in": "path", "required": True,
                         "schema": {"type": "string",
                                    "enum": ["mesh.glb", "pointcloud.ply", "metadata.json"]}},
                    ],
                    "responses": {"200": {"description": "Artifact by media type"},
                                  "404": {"description": "Not found"}},
                }
            },
            "/jobs": {"get": {"summary": "List Jobs",
                              "responses": {"200": {"description": "Recent jobs"}}}},
            "/jobs/{job_id}": {
                "delete": {"summary": "Delete Job", "parameters": [_job_param()],
                           "responses": {"200": {"description": "Deleted"},
                                         "404": {"description": "Job not found"}}}
            },
            "/health": {"get": {"summary": "Health Check",
                                "responses": {"200": {"description": "Service health"}}}},
        },
    }


_DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title} — docs</title>
<style>
 body {{ font: 14px/1.5 system-ui, sans-serif; margin: 2rem auto; max-width: 900px; color: #1a1a2e; }}
 h1 {{ font-size: 1.4rem; }} h2 {{ font-size: 1.05rem; margin: 1.4rem 0 .3rem; }}
 .m {{ display: inline-block; min-width: 4.5em; font-weight: 700; padding: .1em .5em;
      border-radius: 4px; color: #fff; text-align: center; margin-right: .6em; }}
 .GET {{ background: #2b7a4b; }} .POST {{ background: #1f5fa8; }} .DELETE {{ background: #a83232; }}
 code {{ background: #f0f0f5; padding: .1em .35em; border-radius: 3px; }}
 table {{ border-collapse: collapse; margin: .4rem 0 .2rem 1rem; }}
 td, th {{ border: 1px solid #ddd; padding: .25em .6em; font-size: .85rem; text-align: left; }}
 .desc {{ color: #555; margin: .15rem 0 .4rem 1rem; font-size: .9rem; }}
</style></head><body>
<h1>{title} <small>v{version}</small></h1>
<p>Machine-readable schema: <a href="openapi.json"><code>/openapi.json</code></a>
(the reference's FastAPI serves the same document shape).</p>
<div id="paths">{body}</div>
</body></html>"""


def docs_html(doc: dict) -> str:
    """Self-contained HTML rendering of an OpenAPI document — the
    air-gapped stand-in for the reference's CDN-backed Swagger UI at
    ``/docs`` (FastAPI default)."""
    import html as _html

    rows = []
    for path, ops in doc["paths"].items():
        for method, op in ops.items():
            rows.append(
                f'<h2><span class="m {method.upper()}">{method.upper()}'
                f"</span><code>{_html.escape(path)}</code> — "
                f"{_html.escape(op.get('summary', ''))}</h2>"
            )
            if op.get("description"):
                rows.append(
                    f'<p class="desc">{_html.escape(op["description"])}</p>'
                )
            params = op.get("parameters", [])
            body = (
                op.get("requestBody", {})
                .get("content", {})
                .get("multipart/form-data", {})
                .get("schema", {})
                .get("properties", {})
            )
            if params or body:
                cells = []
                for q in params:
                    sch = q.get("schema", {})
                    cells.append(
                        f"<tr><td><code>{_html.escape(q['name'])}</code></td>"
                        f"<td>{q['in']}</td><td>{sch.get('type', '')}</td>"
                        f"<td>{_html.escape(str(sch.get('default', '')))}</td></tr>"
                    )
                for name, sch in body.items():
                    cells.append(
                        f"<tr><td><code>{_html.escape(name)}</code></td>"
                        f"<td>form</td><td>{sch.get('type', '')}</td>"
                        f"<td>{_html.escape(str(sch.get('default', '')))}</td></tr>"
                    )
                rows.append(
                    "<table><tr><th>param</th><th>in</th><th>type</th>"
                    "<th>default</th></tr>" + "".join(cells) + "</table>"
                )
            resp = ", ".join(
                f"{code} ({_html.escape(r.get('description', ''))})"
                for code, r in op.get("responses", {}).items()
            )
            rows.append(f'<p class="desc">responses: {resp}</p>')
    return _DOCS_HTML.format(
        title=doc["info"]["title"],
        version=doc["info"]["version"],
        body="".join(rows),
    )
