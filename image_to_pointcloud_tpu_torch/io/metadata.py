"""GIS metadata generation, key-compatible with the reference
(backend/app.py:391-417): axis-aligned bounds, point count, coordinate
system, and an echo of the request parameters (+ optional gpsReference).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["generate_gis_metadata"]


def generate_gis_metadata(
    points: np.ndarray,
    *,
    coordinate_system: str,
    model: str,
    output_format: str,
    point_density: str,
    depth_scale: float,
    invert_depth: bool,
    smooth_depth: bool,
    gps_coords: Mapping[str, float] | None = None,
) -> dict[str, Any]:
    p = np.asarray(points)
    bounds = {
        "minX": float(p[:, 0].min()),
        "maxX": float(p[:, 0].max()),
        "minY": float(p[:, 1].min()),
        "maxY": float(p[:, 1].max()),
        "minZ": float(p[:, 2].min()),
        "maxZ": float(p[:, 2].max()),
    }
    metadata: dict[str, Any] = {
        "coordinateSystem": coordinate_system,
        "bounds": bounds,
        "pointCount": len(p),
        "generatedWith": model,
        "outputFormat": output_format,
        "pointDensity": point_density,
        "depthScale": depth_scale,
        "invertDepth": invert_depth,
        "smoothDepth": smooth_depth,
    }
    if gps_coords:
        metadata["gpsReference"] = dict(gps_coords)
    return metadata
