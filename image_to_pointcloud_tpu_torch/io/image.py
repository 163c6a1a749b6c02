"""Host-side image decode/encode staging.

The reference decodes uploads with ``cv2.imdecode`` and base64-encodes
PNG previews with ``cv2.imencode`` (backend/app.py:433, 163-166). Here
decode/encode run on host (PIL's native C codecs — libjpeg-turbo/libpng
underneath) producing RGB uint8 arrays that are staged to device; the
data URL format matches the reference's ``data:image/png;base64,...``.
"""

from __future__ import annotations

import base64
import io as _io

import numpy as np

__all__ = [
    "decode_image_rgb",
    "probe_image_size",
    "encode_png",
    "png_data_url",
    "png_data_url_palette",
]


def decode_image_rgb(data: bytes) -> np.ndarray:
    """Decode JPEG/PNG/... bytes → (H, W, 3) RGB uint8 (raises on failure)."""
    from PIL import Image

    img = Image.open(_io.BytesIO(data))
    img = img.convert("RGB")
    return np.asarray(img)


def probe_image_size(data: bytes) -> tuple[int, int]:
    """(height, width) from the image header WITHOUT decoding pixels —
    lets size limits reject a small crafted file before the full decode
    allocates hundreds of MB (PIL parses headers lazily on open)."""
    from PIL import Image

    with Image.open(_io.BytesIO(data)) as img:
        w, h = img.size
    return h, w


def encode_png(rgb: np.ndarray) -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    # compress_level=1 matches OpenCV's imencode('.png') default
    # (IMWRITE_PNG_COMPRESSION=1, the reference's encoder at
    # backend/app.py:163) and is ~4x faster than PIL's default 6 — the
    # preview PNG was the largest single host-side cost per job.
    Image.fromarray(np.ascontiguousarray(rgb.astype(np.uint8))).save(
        buf, format="PNG", compress_level=1
    )
    return buf.getvalue()


def png_data_url(rgb: np.ndarray) -> str:
    return "data:image/png;base64," + base64.b64encode(encode_png(rgb)).decode("ascii")


def png_data_url_palette(gray: np.ndarray, palette_rgb: np.ndarray) -> str:
    """Paletted-PNG data URL that canvas-decodes to ``palette_rgb[gray]``.

    One zlib channel instead of three (~10x cheaper to encode than the
    equivalent RGB PNG) — used for the depth preview, whose colors are by
    construction a 256-entry LUT of the normalized depth
    (reference backend/app.py:153 applyColorMap(PLASMA))."""
    from PIL import Image

    g = np.ascontiguousarray(gray.astype(np.uint8))
    im = Image.frombuffer("P", (g.shape[1], g.shape[0]), g.tobytes())
    im.putpalette(
        np.ascontiguousarray(palette_rgb.astype(np.uint8)).tobytes()
    )
    buf = _io.BytesIO()
    im.save(buf, format="PNG", compress_level=1)
    return (
        "data:image/png;base64,"
        + base64.b64encode(buf.getvalue()).decode("ascii")
    )
