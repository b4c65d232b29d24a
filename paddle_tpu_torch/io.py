"""Read the LM artifacts the JAX package writes.

`read_lm_artifact(path)` parses the version-3 container of
`paddle_tpu.io.export_lm_artifact`:

    [8-byte little-endian meta length][JSON meta][StableHLO blob]
    [npz weights payload][optional AOT section]

and returns `(meta, weights)`: the meta dict (its `lm` section holds
the `LMSpec` and the baked `GenerationConfig`) and `{name: np.ndarray}`.
The StableHLO blob and any AOT section are JAX executables the port
cannot run; they are skipped, never read.
"""

from __future__ import annotations

import io as _bytesio
import json
import os

import numpy as np

__all__ = ["read_lm_artifact", "ARTIFACT_MAGIC"]

ARTIFACT_MAGIC = "PTART"
ARTIFACT_VERSION = 3
_MAX_META_BYTES = 1 << 26


def _error(path, why):
    return ValueError(f"{path}: not a loadable paddle_tpu LM artifact "
                      f"({why})")


def _read_meta(path):
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise _error(path, f"file is {size} bytes, too short for the "
                         "meta header")
        n = int.from_bytes(head, "little")
        if not 0 < n <= min(size - 8, _MAX_META_BYTES):
            raise _error(path, f"meta header length {n} is outside the "
                         f"file ({size} bytes)")
        try:
            meta = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise _error(path, "meta header is not JSON") from None
    if not isinstance(meta, dict):
        raise _error(path, "meta header is not a JSON object")
    if meta.get("magic") != ARTIFACT_MAGIC:
        raise _error(path, f"unknown magic {meta.get('magic')!r}")
    version = int(meta.get("version", 1))
    if version > ARTIFACT_VERSION:
        raise _error(path, f"artifact version {version} is newer than "
                     f"this reader supports ({ARTIFACT_VERSION})")
    try:
        blob = int(meta["blob_bytes"])
        params = int(meta.get("params_bytes") or 0)
        aot = sum(int(r["bytes"])
                  for r in (meta.get("aot") or {}).get("rungs", ()))
    except (KeyError, TypeError, ValueError, AttributeError):
        raise _error(path, "malformed section lengths in the meta "
                     "header") from None
    expected = 8 + n + blob + params + aot
    if size != expected:
        raise _error(path, f"file is {size} bytes but the header promises "
                     f"{expected}: truncated write or trailing garbage")
    return meta, 8 + n + blob, params


def read_lm_artifact(path):
    """(meta, {name: np.ndarray}) of an LM artifact."""
    meta, offset, n_params = _read_meta(path)
    if not meta.get("lm"):
        raise _error(path, "no meta['lm'] section: a one-shot inference "
                     "artifact, not a generative LM")
    if not n_params:
        raise _error(path, "LM artifact has no weights payload")
    with open(path, "rb") as f:
        f.seek(offset)
        payload = f.read(n_params)
    if len(payload) != n_params:
        raise _error(path, "weights payload is truncated")
    with np.load(_bytesio.BytesIO(payload)) as data:
        weights = {name: data[name] for name in data.files}
    return meta, weights
