"""Save and load models in the JAX package's formats.

Inference models (the port of `paddle_tpu/io.py`'s json format): a
directory with `__model__.json` (the pruned Program's `to_dict` plus the
feed and fetch names) and `params.npz` (the persistable arrays). A
directory either package wrote loads in the other unchanged, f32 or
quantized by `quant.quantize_inference_model`:

    save_inference_model(dirname, feed_names, target_vars, executor,
                         main_program=None, scope=None)
    program, feed_names, fetch_vars = load_inference_model(dirname,
                                                           executor)

`load_persistables` puts every array into the scope as a tensor on the
executor's device, so a served model's weights cross to the card once,
at load; a quantized model's int8 matmul weights are then laid out
column-major on the card (`quant.place_int8_weights`).
`save_persistables` writes every array C-ordered, whatever its strides
on the device, so the file is the same for either layout. The
reference's binary ProgramDesc format ("pb") is not ported.

LM artifacts: `read_lm_artifact(path)` parses the version-3 container
of `paddle_tpu.io.export_lm_artifact`:

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
import torch

from . import framework
from .executor import global_scope
from .framework import Program

__all__ = ["save_persistables", "load_persistables", "save_inference_model",
           "load_inference_model", "read_lm_artifact", "ARTIFACT_MAGIC"]


def _persistable_names(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def save_persistables(executor, dirname, main_program=None, scope=None):
    """Write the program's persistables that the scope holds to
    `dirname/params.npz`; returns their sorted names."""
    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for name in _persistable_names(program):
        if scope.has(name):
            val = scope.get(name)
            arrays[name] = np.asarray(
                val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
                else val, order="C")
    np.savez(os.path.join(dirname, "params.npz"), **arrays)
    return sorted(arrays)


def load_persistables(executor, dirname, main_program=None, scope=None):
    """Read `dirname/params.npz` into the scope: each of the program's
    persistables, as a tensor on `executor.device`."""
    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    with np.load(os.path.join(dirname, "params.npz")) as data:
        wanted = set(_persistable_names(program))
        for name in data.files:
            if name in wanted:
                scope.set(name, torch.from_numpy(
                    np.ascontiguousarray(data[name])).to(executor.device))
    return scope


def _prune_for_inference(program, feed_names, fetch_names):
    """Dead-op elimination keeping only ops needed for the fetches
    (framework/prune.cc analog), with train-only ops stripped."""
    from .ops.registry import optimizer_op_types
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    optimizer_types = optimizer_op_types()  # OpDef metadata, not a list
    for op in reversed(block.ops):
        if op.type.endswith("_grad") or op.type in optimizer_types:
            continue
        if any(n in needed for names in op.outputs.values() for n in names):
            keep.append(op)
            for names in op.inputs.values():
                needed.update(n for n in names if n)
    keep.reverse()
    block.ops = keep
    used = set(feed_names)
    for op in keep:
        used.update(n for ns in op.inputs.values() for n in ns if n)
        used.update(n for ns in op.outputs.values() for n in ns if n)
    used.update(fetch_names)
    # keep seqlen companions
    for n, v in list(block.vars.items()):
        if v.seq_len_var and n in used:
            used.add(v.seq_len_var)
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    pruned.bump()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, scope=None, format="json"):
    """Prune the program to what the targets need and write it with its
    persistables (the reference's json format). Returns the fetch
    names."""
    if format != "json":
        raise ValueError(f"inference-model format {format!r} is not "
                         "ported (json only; the binary ProgramDesc "
                         "format waits for proto_io)")
    program = main_program or framework.default_main_program()
    fetch_names = [v.name if isinstance(v, framework.Variable) else v
                   for v in target_vars]
    pruned = _prune_for_inference(program, list(feeded_var_names),
                                  fetch_names)
    os.makedirs(dirname, exist_ok=True)
    # a stale binary model beside the json one would be ambiguous
    for fname in ("__model__.json", "__model__", "__targets__.json"):
        try:
            os.remove(os.path.join(dirname, fname))
        except FileNotFoundError:
            pass
    with open(os.path.join(dirname, "__model__.json"), "w") as f:
        json.dump({"program": pruned.to_dict(),
                   "feed_names": list(feeded_var_names),
                   "fetch_names": fetch_names}, f)
    save_persistables(executor, dirname, pruned, scope)
    return fetch_names


def load_inference_model(dirname, executor, scope=None):
    """(program, feed_names, fetch_vars) of a json inference model, its
    persistables loaded into `scope` on `executor.device`. A quantized
    model's ops this runtime cannot execute fall back to f32 per op
    (quant.ensure_loadable)."""
    json_path = os.path.join(dirname, "__model__.json")
    if not os.path.exists(json_path):
        raise FileNotFoundError(
            f"{json_path} not found: the port loads json inference models "
            "(the binary ProgramDesc format is not ported)")
    with open(json_path) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, scope)
    from . import quant
    if quant.has_quant_ops(program):
        quant.ensure_loadable(program, scope or global_scope())
        quant.place_int8_weights(program, scope or global_scope())
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars

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
