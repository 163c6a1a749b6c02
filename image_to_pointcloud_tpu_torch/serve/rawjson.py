"""Raw-fragment JSON encoding for the serving result path.

The v1 status contract inlines a <=20k-point float preview into every
completed job's JSON (reference backend/app.py:496-506, 545-559). On a
one-core host, `json.dumps` float repr over ~1.7 MB of numbers is the
single biggest serialization cost per job; the native serializer
(native/src/serialize.cpp) produces those array fragments at
memory-bandwidth speed. :class:`RawJSON` lets a handler embed such a
pre-serialized fragment inside an otherwise ordinary dict, and
:func:`dumps_raw` splices the fragments into the encoded body.

Splice safety: the placeholder contains a NUL control character, which
`json.dumps` always escapes to ``BACKSLASH-u0000`` inside genuine string
content (and a literal backslash in content doubles), so the quoted
placeholder pattern cannot collide with user data.
"""

from __future__ import annotations

import json
from typing import Any

__all__ = [
    "RawJSON",
    "dumps_raw",
    "float_triplets",
    "int_triplets",
    "int_list",
]

_NUL = chr(0)


class RawJSON:
    """A pre-serialized JSON fragment (bytes) embeddable in a dict."""

    __slots__ = ("data",)

    def __init__(self, data: bytes | str):
        self.data = data.encode() if isinstance(data, str) else data

    def parsed(self) -> Any:
        """Decode back to Python structures (tests / non-HTTP consumers)."""
        return json.loads(self.data)


def dumps_raw(obj: Any) -> bytes:
    """``json.dumps(obj).encode()`` with RawJSON fragments spliced in.

    The placeholder carries a fresh 128-bit nonce per call, so
    user-controlled strings (which are fixed before the nonce exists)
    cannot forge or collide with a splice point — including via escaped
    quotes or literal NUL bytes in request params. If the spliced text
    still doesn't account for every fragment (defense in depth), fall
    back to parsing the fragments and re-dumping, which is slow but
    always correct.
    """
    import secrets

    frags: list[bytes] = []
    nonce = secrets.token_hex(16)

    def default(o):
        if isinstance(o, RawJSON):
            frags.append(o.data)
            return f"{_NUL}{nonce}:{len(frags) - 1}{_NUL}"
        raise TypeError(
            f"Object of type {type(o).__name__} is not JSON serializable"
        )

    text = json.dumps(obj, default=default)
    if not frags:
        return text.encode()
    # json.dumps escapes the placeholder's NULs, so each placeholder
    # appears in the output as the quoted string
    # "BACKSLASH-u0000<nonce>:<i>BACKSLASH-u0000".
    opener = '"' + "\\u0000" + nonce + ":"
    closer = "\\u0000" + '"'
    parts = text.split(opener)
    if len(parts) != len(frags) + 1:
        return json.dumps(obj, default=lambda o: o.parsed()).encode()
    out = [parts[0].encode()]
    try:
        for part in parts[1:]:
            idx, rest = part.split(closer, 1)
            out.append(frags[int(idx)])
            out.append(rest.encode())
    except (ValueError, IndexError):
        return json.dumps(obj, default=lambda o: o.parsed()).encode()
    return b"".join(out)


def float_triplets(arr):
    """(N,3) float array → reference preview value (``.astype(float)
    .tolist()`` shape, backend/app.py:504-505): native fragment for f32
    and f64 inputs (exact shortest-round-trip doubles either way), plain
    nested lists otherwise — identical parsed values in all cases."""
    import numpy as np

    from image_to_pointcloud_tpu_torch import native

    a = np.asarray(arr)
    frag = None
    if a.dtype == np.float32:
        frag = native.json_f32_triplets(a)
    elif a.dtype == np.float64:
        frag = native.json_f64_triplets(a)
    if frag is not None:
        return RawJSON(frag)
    return a.astype(float).tolist()


def int_triplets(arr):
    """(N,3) int array → nested-int-triplet JSON value."""
    import numpy as np

    from image_to_pointcloud_tpu_torch import native

    a = np.asarray(arr)
    if a.dtype.kind in "iuf":
        b = a.astype(np.int64)  # truncates floats like .astype(int)
        if b.size == 0 or (b.min() >= -(2**31) and b.max() < 2**31):
            frag = native.json_i32_triplets(b.astype(np.int32))
            if frag is not None:
                return RawJSON(frag)
    return a.astype(int).tolist()


def int_list(arr):
    """Flat int array → JSON value (native fragment or list of ints)."""
    import numpy as np

    from image_to_pointcloud_tpu_torch import native

    a = np.asarray(arr).reshape(-1)
    if a.dtype in (np.int32, np.int64) and (
        a.size == 0 or (a.min() >= -(2**31) and a.max() < 2**31)
    ):
        frag = native.json_i32_list(a.astype(np.int32))
        if frag is not None:
            return RawJSON(frag)
    return a.astype(int).tolist()
