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

Training checkpoints (the reference's `save_checkpoint` /
`load_checkpoint`): a directory with `params.npz` (every persistable),
`trainer_state.npz` (the random stream's state) and `checkpoint.json`
(format version 1, global step, md5 digests of both files, the saved
names and the caller's `extra`, e.g. the Trainer's pass / batch
position). The write is atomic (`<dir>.tmp`, then a swap through
`<dir>.old`); a load verifies the digests and falls back to an intact
`.old` copy. A checkpoint either package wrote loads in the other: every
persistable, the step and the position bit-exact. The random streams
differ by nature: the reference keeps its JAX key as `__rng_key__`, the
port the state of the scope's `torch.Generator` as
`__torch_rng_state_<device type>__`; each package restores its own key
and ignores the other's, so a run that crosses packages continues with
the receiving package's own stream.

    save_checkpoint(executor, dirname, main_program=None, scope=None,
                    global_step=0, extra_meta=None)
    step = load_checkpoint(executor, dirname, main_program=None,
                           scope=None)

Artifacts: the port reads the version-3 container that
`paddle_tpu.io.export_lm_artifact` and `export_inference_artifact(...,
embed_program=True)` write:

    [8-byte little-endian meta length][JSON meta][StableHLO blob]
    [npz payload][optional AOT section]

`read_artifact_meta(path)` validates the header against the file size;
`read_lm_artifact(path)` returns `(meta, weights)` (its `lm` section
holds the `LMSpec` and the baked `GenerationConfig`);
`read_embedded_program(path)` returns `(meta, Program, arrays)`, which
`serving.InferenceEngine.from_artifact` serves. The StableHLO blob and
any AOT section are JAX executables the port cannot run; they are
skipped, never read. The port writes no artifacts.
"""

from __future__ import annotations

import functools
import io as _bytesio
import json
import os
import shutil
import time
import warnings

import numpy as np
import torch

from . import framework, monitor
from .executor import _GENERATOR_KEY, global_scope
from .framework import Program

__all__ = ["save_persistables", "load_persistables", "save_inference_model",
           "load_inference_model", "read_lm_artifact", "read_artifact_meta",
           "read_embedded_program", "ARTIFACT_MAGIC",
           "save_checkpoint", "load_checkpoint", "checkpoint_exists",
           "read_checkpoint_meta", "resolve_checkpoint_dir",
           "CHECKPOINT_VERSION", "BF16PersistableError"]


class BF16PersistableError(TypeError):
    """A bfloat16 tensor reached save_persistables: numpy has no
    bfloat16, and persistables stay float32 or integer (amp keeps f32
    master weights), so one in bf16 is a program fault."""


def _timed_io(metric):
    """Route an IO entry point's wall time into the telemetry registry
    (histogram `metric`, seconds) and a span. Free when telemetry is
    off."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not monitor.enabled():
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with monitor.span(f"io/{fn.__name__}"):
                out = fn(*args, **kwargs)
            monitor.histogram_observe(metric, time.perf_counter() - t0)
            return out
        return wrapper
    return deco


def _persistable_names(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _host_array(name, val):
    if isinstance(val, torch.Tensor):
        if val.dtype == torch.bfloat16:
            raise BF16PersistableError(
                f"persistable {name!r} is bfloat16: persistables stay "
                "float32 or integer (amp keeps f32 master weights), and "
                "npz has no bfloat16")
        val = val.detach().cpu().numpy()
    return np.asarray(val, order="C")


@_timed_io("io.save_persistables_s")
def save_persistables(executor, dirname, main_program=None, scope=None):
    """Write the program's persistables that the scope holds to
    `dirname/params.npz`; returns their sorted names."""
    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {name: _host_array(name, scope.get(name))
              for name in _persistable_names(program) if scope.has(name)}
    np.savez(os.path.join(dirname, "params.npz"), **arrays)
    return sorted(arrays)


@_timed_io("io.load_persistables_s")
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


def _sub_block_names(program, op):
    """Every var name the ops of `op`'s sub-blocks (recursively) read or
    write: a kept control-flow op needs them, among them a While's loop
    vars, whose first values the global block computes."""
    from .ops.registry import sub_block_idxs
    names, stack = set(), list(sub_block_idxs(op))
    while stack:
        blk = program.blocks[stack.pop()]
        for o in blk.ops:
            for ns in list(o.inputs.values()) + list(o.outputs.values()):
                names.update(n for n in ns if n)
            stack.extend(sub_block_idxs(o))
    return names


def _prune_for_inference(program, feed_names, fetch_names):
    """Dead-op elimination keeping only ops needed for the fetches
    (framework/prune.cc analog), with train-only ops stripped. Every
    block is carried (`clone`), so a kept control-flow op keeps its
    sub-blocks, and the global block keeps what they read."""
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
            needed.update(_sub_block_names(pruned, op))
    keep.reverse()
    block.ops = keep
    used = set(feed_names)
    for op in keep:
        used.update(n for ns in op.inputs.values() for n in ns if n)
        used.update(n for ns in op.outputs.values() for n in ns if n)
        used.update(_sub_block_names(pruned, op))
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

# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

CHECKPOINT_VERSION = 2          # readers accept <= this
_PLAIN_FORMAT_VERSION = 1       # the single-writer npz format


def _rng_state_key(device):
    return f"__torch_rng_state_{torch.device(device).type}__"


def _is_primary():
    """True on the process that writes checkpoints: the port runs on one
    card in one process, so always."""
    return True


def _md5_file(path, chunk=1 << 20):
    import hashlib
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _probe_checkpoint_dir(dirname, check_integrity=True):
    """(meta, None) when `dirname` holds a complete, digest-clean
    checkpoint; (None, reason) otherwise — one source of truth for both
    usability decisions and error messages, naming the exact file whose
    digest failed."""
    try:
        with open(os.path.join(dirname, "checkpoint.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None, "missing or corrupt checkpoint.json"
    if not isinstance(meta, dict):
        return None, "corrupt checkpoint.json"
    if meta.get("format") == "orbax-sharded":
        state_dir = meta.get("state_dir", "sharded_state")
        if not os.path.isdir(os.path.join(dirname, state_dir)):
            return None, f"missing sharded state dir {state_dir!r}"
        return meta, None
    if check_integrity:
        for fname, key in (("params.npz", "md5"),
                           ("trainer_state.npz", "md5_state")):
            if key not in meta:
                continue
            try:
                if _md5_file(os.path.join(dirname, fname)) != meta[key]:
                    return None, f"{fname} digest mismatch"
            except OSError:
                return None, f"{fname} missing or unreadable"
    return meta, None


def _integrity_failure(dirname):
    return _probe_checkpoint_dir(dirname)[1] or "unusable contents"


def resolve_checkpoint_dir(dirname, check_integrity=True):
    """(usable_dir, meta) for a checkpoint location: `dirname` itself
    when intact, else the `.old` sibling the atomic swap leaves behind
    (a crash between save_checkpoint's two renames, or a corrupted
    params.npz, must not strand an otherwise-recoverable run), else
    (None, None)."""
    meta, _ = _probe_checkpoint_dir(dirname, check_integrity)
    if meta is not None:
        return dirname, meta
    olddir = dirname.rstrip("/\\") + ".old"
    meta, _ = _probe_checkpoint_dir(olddir, check_integrity)
    if meta is not None:
        return olddir, meta
    return None, None


def checkpoint_exists(dirname, check_integrity=True):
    """True when `dirname` (or its `.old` fallback) holds a loadable
    checkpoint. check_integrity=False skips digest hashing — the cheap
    probe for hot restore decisions; load_checkpoint verifies for
    real."""
    return resolve_checkpoint_dir(dirname, check_integrity)[0] is not None


def read_checkpoint_meta(dirname):
    """The checkpoint.json contents (version, global_step, digests, and
    any caller `extra` — e.g. the Trainer's pass position), resolved
    through the same primary / .old fallback as load_checkpoint, with
    the cheap probe only (a meta peek must not hash a multi-GB
    params.npz)."""
    _, meta = resolve_checkpoint_dir(dirname, check_integrity=False)
    if meta is not None:
        return meta
    with open(os.path.join(dirname, "checkpoint.json")) as f:
        return json.load(f)


@_timed_io("io.checkpoint_save_s")
def save_checkpoint(executor, dirname, main_program=None, scope=None,
                    global_step=0, extra_meta=None, sharded=False,
                    retry_policy=None):
    """Resume-complete checkpoint: persistable vars + the random
    stream's state + step.

    Unlike `save_persistables` (parameters only), a checkpoint restores
    a *run*: the scope generator's state and the global step travel with
    the arrays, and md5 digests of both files are kept in
    checkpoint.json. The write is atomic: everything lands in
    `<dirname>.tmp`, which replaces `dirname` only on success, so every
    crash window leaves a loadable copy in `dirname` or `<dirname>.old`
    (load_checkpoint's fallback). Fault sites `ckpt_save` (temp dir
    written, before the swap) and `ckpt_swap` (between the two renames).
    Transient IO failures are retried per `retry_policy` (default: 3
    attempts, exponential backoff), counted as resilience.ckpt_retries.
    Returns the path. `sharded=True` (the reference's orbax per-shard
    save) is not ported: the port runs on one card.
    """
    from .resilience import RetryPolicy, call_with_retry
    from .resilience import faults as _faults

    if sharded:
        raise NotImplementedError(
            "save_checkpoint(sharded=True): sharded (orbax) checkpoints are "
            "not ported; the port checkpoints one card's state (ROADMAP "
            "A11)")
    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    if not _is_primary():
        return None

    def _write_and_swap():
        tmpdir = dirname.rstrip("/\\") + ".tmp"
        if os.path.exists(tmpdir):
            shutil.rmtree(tmpdir)
        os.makedirs(tmpdir)
        saved = save_persistables(executor, tmpdir, program, scope)
        extra = {}
        gen = scope.get(_GENERATOR_KEY)
        if gen is not None:
            extra[_rng_state_key(gen.device)] = gen.get_state().numpy()
        np.savez(os.path.join(tmpdir, "trainer_state.npz"), **extra)
        meta = {"version": _PLAIN_FORMAT_VERSION,
                "global_step": int(global_step),
                "md5": _md5_file(os.path.join(tmpdir, "params.npz")),
                "md5_state": _md5_file(os.path.join(tmpdir,
                                                    "trainer_state.npz")),
                "vars": saved, "extra": dict(extra_meta or {})}
        with open(os.path.join(tmpdir, "checkpoint.json"), "w") as f:
            json.dump(meta, f)
        # the previous checkpoint survives a crash anywhere before here
        _faults.fire("ckpt_save")
        # atomic swap. A stale `.old` (left by a crash between the two
        # renames of an earlier save) is deleted only once a NEWER copy
        # is in place — it may be the only loadable checkpoint until then
        olddir = dirname.rstrip("/\\") + ".old"
        if os.path.exists(dirname):
            if os.path.exists(olddir):
                shutil.rmtree(olddir)
            os.rename(dirname, olddir)
        # the half-swapped window: `dirname` gone, previous copy in .old
        _faults.fire("ckpt_swap")
        os.rename(tmpdir, dirname)
        if os.path.exists(olddir):
            shutil.rmtree(olddir)
        return dirname

    return call_with_retry(_write_and_swap,
                           policy=retry_policy or RetryPolicy(),
                           counter="resilience.ckpt_retries")


def _restore_rng_state(executor, scope, path):
    """Set the scope's generator on the executor's device to the state
    this package saved for that device type; another package's key
    (`__rng_key__`) or another device type's state is ignored."""
    if not os.path.exists(path):
        return
    key = _rng_state_key(executor.device)
    with np.load(path) as data:
        if key not in data.files:
            return
        state = torch.from_numpy(np.ascontiguousarray(data[key]))
    gen = scope.get(_GENERATOR_KEY)
    if gen is None or gen.device != executor.device:
        gen = torch.Generator(device=executor.device)
        scope.set(_GENERATOR_KEY, gen)
    gen.set_state(state)


@_timed_io("io.checkpoint_load_s")
def load_checkpoint(executor, dirname, main_program=None, scope=None,
                    check_integrity=True, return_meta=False):
    """Restore a `save_checkpoint` directory (either package's). Returns
    the global step (or `(global_step, meta)` with return_meta=True).

    The md5 / md5_state digests recorded in checkpoint.json are verified
    before anything enters the scope (check_integrity=False skips). On a
    digest mismatch, a missing or corrupt checkpoint.json, or a
    half-swapped directory, the load falls back to the `.old` directory
    — counted as resilience.ckpt_fallback_loads. Only when neither copy
    is trustworthy does it raise. Fault site `ckpt_load`, before
    reading. The loaded state replaces the scope's, so the scope's
    `state_invalidated` mark is cleared."""
    from .resilience import faults as _faults

    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    _faults.fire("ckpt_load")
    src, meta = resolve_checkpoint_dir(dirname, check_integrity)
    if meta is None:
        if not os.path.exists(os.path.join(dirname, "checkpoint.json")):
            raise FileNotFoundError(
                f"no loadable checkpoint at {dirname}: checkpoint.json "
                "is missing and there is no intact .old fallback")
        raise IOError(
            f"checkpoint {dirname}: {_integrity_failure(dirname)} — "
            "truncated or corrupted write, and no intact .old fallback")
    if src != dirname:
        monitor.counter_inc("resilience.ckpt_fallback_loads")
        warnings.warn(
            f"checkpoint {dirname} is missing or corrupt — loading the "
            f"previous checkpoint from {src}", RuntimeWarning,
            stacklevel=2)
    if meta.get("version", 0) > CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {meta['version']} is newer than this "
            f"runtime supports ({CHECKPOINT_VERSION})")
    if meta.get("format") == "orbax-sharded":
        raise NotImplementedError(
            f"checkpoint {dirname} is a sharded (orbax) checkpoint: not "
            "ported; the port loads the single-writer npz format (ROADMAP "
            "A11)")
    load_persistables(executor, src, program, scope)
    _restore_rng_state(executor, scope,
                       os.path.join(src, "trainer_state.npz"))
    scope.state_invalidated = False
    step = int(meta.get("global_step", 0))
    return (step, meta) if return_meta else step


ARTIFACT_MAGIC = "PTART"
ARTIFACT_VERSION = 3
_MAX_META_BYTES = 1 << 26


def _aot_rung_bytes(meta):
    """Bytes of the AOT section the meta header promises."""
    aot = meta.get("aot") or {}
    return sum(int(r["bytes"]) for r in aot.get("rungs", ()))


def _params_bytes(meta):
    """Bytes of the embedded-params npz section the meta header promises
    (0 when the artifact embeds no program)."""
    return int(meta.get("params_bytes") or 0)


def _artifact_error(path, why):
    return ValueError(f"{path}: not a loadable paddle_tpu inference "
                      f"artifact ({why})")


def _read_artifact(path):
    """The validated meta header of an artifact, read header-only: the
    payload regions are checked arithmetically against the file size
    (the reference's one size law, so a truncated write and trailing
    garbage are both named errors) and nothing past the header is
    read. The StableHLO module and any AOT rungs are JAX executables the
    port never reads."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise _artifact_error(path, f"file is {size} bytes — too "
                                  "short for the meta header")
        n = int.from_bytes(head, "little")
        if not 0 < n <= min(size - 8, _MAX_META_BYTES):
            raise _artifact_error(
                path, f"meta header length {n} is outside the file "
                f"({size} bytes) — wrong format or truncated")
        try:
            meta = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise _artifact_error(path, "meta header is not JSON") \
                from None
    if not isinstance(meta, dict) or "feed_names" not in meta:
        raise _artifact_error(path, "meta header lacks feed_names")
    magic = meta.get("magic")
    if magic is not None:
        if magic != ARTIFACT_MAGIC:
            raise _artifact_error(path, f"unknown magic {magic!r}")
        version = int(meta.get("version", 1))
        if version > ARTIFACT_VERSION:
            raise _artifact_error(
                path, f"artifact version {version} is newer than "
                f"this runtime supports ({ARTIFACT_VERSION})")
    try:
        aot_bytes = _aot_rung_bytes(meta)
        params_bytes = _params_bytes(meta)
    except (KeyError, TypeError, ValueError, AttributeError):
        raise _artifact_error(
            path, "malformed AOT rung table or params length in "
            "the meta header") from None
    want = meta.get("blob_bytes")
    if want is not None:
        expected = 8 + n + int(want) + params_bytes + aot_bytes
        if size != expected:
            raise _artifact_error(
                path, f"file is {size} bytes but the header "
                f"promises {expected} (meta + module"
                + (f" + {params_bytes}B of embedded params"
                   if params_bytes else "")
                + (f" + {aot_bytes}B of AOT rungs" if aot_bytes
                   else "")
                + ") — truncated write or trailing garbage")
    if size - 8 - n - params_bytes - aot_bytes <= 0:
        raise _artifact_error(path, "empty StableHLO payload")
    return meta


def read_artifact_meta(path):
    """The artifact's validated meta header (feed / fetch names,
    input_specs, symbolic_batch, the lm / quant / program sections)
    without reading its payloads: a stat and an O(header) read."""
    return _read_artifact(path)


def _read_params_payload(path, meta):
    """The raw embedded-params npz bytes of a version-3 artifact (b""
    when it embeds none): [8B len][meta][blob][params][aot rungs]; a
    short read is a named truncation error."""
    n_params = _params_bytes(meta)
    if not n_params:
        return b""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        f.seek(8 + n + int(meta["blob_bytes"]))
        payload = f.read(n_params)
    if len(payload) != n_params:
        raise _artifact_error(path, "embedded params section is "
                              "truncated")
    return payload


def read_embedded_program(path):
    """(meta, Program, {name: array}) of a version-3 artifact written by
    `paddle_tpu.io.export_inference_artifact(..., embed_program=True)`:
    the pruned inference program (the port's `Program.from_dict`) and
    its persistable arrays. Raises a named error on a plain artifact,
    whose weights exist only as constants of the StableHLO module,
    telling the caller how to re-export."""
    meta = _read_artifact(path)
    payload = _read_params_payload(path, meta)
    if not payload or "program" not in meta:
        raise ValueError(
            f"{path}: artifact does not embed its program/params — "
            "re-export it with export_inference_artifact(..., "
            "embed_program=True) to make it quantizable")
    program = Program.from_dict(meta["program"])
    with np.load(_bytesio.BytesIO(payload)) as data:
        arrays = {name: data[name] for name in data.files}
    return meta, program, arrays


def read_lm_artifact(path):
    """(meta, {name: np.ndarray}) of an LM artifact
    (`paddle_tpu.io.export_lm_artifact`)."""
    meta = _read_artifact(path)
    if not meta.get("lm"):
        raise _artifact_error(
            path, "not a generative-LM artifact (no meta['lm']) — "
            "one-shot inference artifacts serve through "
            "InferenceEngine.from_artifact")
    payload = _read_params_payload(path, meta)
    if not payload:
        raise _artifact_error(path, "LM artifact has no weights payload")
    with np.load(_bytesio.BytesIO(payload)) as data:
        weights = {name: data[name] for name in data.files}
    return meta, weights
