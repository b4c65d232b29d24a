"""Post-training int8 quantization for the serving path.

The port's copy of `paddle_tpu/quant.py` (all but `quantize_artifact`,
which rewrites StableHLO artifacts and stays with the JAX package). It
quantizes a PRUNED INFERENCE program post-training: weights symmetric
per-channel to int8 (matmul, conv, embedding and the fused transformer
planes), optionally
activations through calibrated absmax / percentile observers, and
rewrites the ops to their `quant_*` twins (ops/quant_ops.py). The
rewritten Program text and the int8 arrays are the reference's, so a
model directory either package quantized serves in both.

Scheme: SCHEME = "int8-sym-perchannel" is the family name in reports;
quant_ops.KERNEL_ID = "int8.sym.perchannel/1" is the executable-kernel
id the fallback contract keys on:

  scale_c = absmax_c / 127      (per output channel c; 1.0 where the
                                 plane is all-zero so dequant is exact)
  q = clip(round(w / scale), -127, 127) int8
  dequant = q * scale           (zero-point 0 — symmetric)

Activations default to DYNAMIC per-row quantization (the scale comes
from each row's absmax at run time). `activations=True` runs
representative feed batches through the program and bakes a STATIC
scalar scale per quantized matmul input instead.

Entry points:

  quantize_program(program, scope, ...)  -> (qprog, qscope, report)
  quantize_inference_model(model_dir, out_dir, ...)  # save_inference_
                                                     # model layout
  ensure_loadable(program, scope)        # load-time per-op fallback
  place_int8_weights(program, scope)     # int8 matmul weights
                                         # column-major on the card

The scale math runs on the host in numpy (float64, as the reference),
so the int8 arrays are bitwise the reference's; the quantized arrays go
back into the scope as tensors on the device their f32 weight was on.

Layout on the card: the int8 matmul kernel (K6) reads its weight
K-major, so every int8 weight a `quant_mul` / `quant_matmul` reads is
stored on a CUDA device as the column-major view `w.t().contiguous().t()`
of the same [K, N] values (`place_int8_weights`, run by
`quantize_program` and at load by `io.load_inference_model`): the same
bytes on the card, the same `.cpu().numpy()` values, no per-dispatch
transpose. On the CPU nothing moves.

Fallback contract: a runtime loading a quantized program whose kernel
id or op type it does not support warns and dequantizes THAT op back to
f32 — a quantized model may serve slower on a foreign runtime, never
crash.
"""

from __future__ import annotations

import json
import os
import threading
import warnings

import numpy as np
import torch

from . import monitor
from .ops import quant_ops
from .ops import registry as op_registry

__all__ = ["SCHEME", "quantize_array", "quantize_program",
           "quantize_inference_model", "calibrate_activations",
           "has_quant_ops", "ensure_loadable", "place_int8_weights",
           "stats", "record_artifact_loaded"]

SCHEME = "int8-sym-perchannel"
_SCALE_SUFFIX = "@QSCALE"
_ACT_SUFFIX = "@QACT"
# weights smaller than this stay f32: biases / LN gains are noise in
# the byte count and their quantization error is pure downside
DEFAULT_MIN_ELEMENTS = 1024


def _host(value):
    """numpy view of a scope value (a tensor on any device, or numpy)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _like(arr, ref):
    """`arr` as a tensor on the device of the scope value `ref`."""
    dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


# ---------------------------------------------------------------------------
# scale math
# ---------------------------------------------------------------------------

def quantize_array(w, reduce_axes):
    """(int8 q, f32 scale) with `scale = absmax/127` reduced over
    `reduce_axes` (keepdims — broadcastable against w for the uniform
    `dequantize` contract). All-zero channels get scale 1.0 so dequant
    reproduces the zeros bit-exactly."""
    w = _host(w)
    absmax = np.max(np.abs(w.astype(np.float64)), axis=tuple(reduce_axes),
                    keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.round(w.astype(np.float64) / scale), -127, 127)
    return q.astype(np.int8), scale


# ---------------------------------------------------------------------------
# per-op-type quantization specs
# ---------------------------------------------------------------------------

class _Spec:
    """How one op type quantizes: which input slots hold weights, the
    per-channel reduction axes for each, and (for the int8-dot ops)
    which input is the activation a calibrator observes."""

    def __init__(self, weight_axes, act_slot=None, eligible=None):
        self.weight_axes = weight_axes      # slot -> fn(op, w) -> axes
        self.act_slot = act_slot            # calibratable input slot
        self._eligible = eligible

    def eligible(self, op, w_by_slot):
        return self._eligible(op, w_by_slot) if self._eligible else True


def _mul_axes(op, w):
    ync = op.attrs.get("y_num_col_dims", 1)
    return tuple(range(ync))


def _matmul_ok(op, w_by_slot):
    y = w_by_slot.get("Y")
    return (y is not None and y.ndim == 2
            and not op.attrs.get("transpose_Y", False))


# The reference's whole table, so a rewritten program's text is the
# reference's. transformer_stack's four
# matmul planes take per-layer, per-output-channel scales ([L, 1, N])
# and run quant_transformer_stack.
_SPECS = {
    "mul": _Spec({"Y": _mul_axes}, act_slot="X"),
    "matmul": _Spec({"Y": lambda op, w: (0,)}, act_slot="X",
                    eligible=_matmul_ok),
    "conv2d": _Spec({"Filter": lambda op, w: (1, 2, 3)}),
    "depthwise_conv2d": _Spec({"Filter": lambda op, w: (1, 2, 3)}),
    "lookup_table": _Spec({"W": lambda op, w: (1,)}),
    "transformer_stack": _Spec(
        {s: (lambda op, w: (1,)) for s in ("Wqkv", "Wproj",
                                           "Wup", "Wdown")}),
}


def _weight_uses(program):
    """var name -> list of (block_idx, op, slot) uses, over every
    block: a weight fed to anything besides one consistent quantizable
    slot cannot change dtype under that consumer's feet."""
    uses = {}
    for blk in program.blocks:
        for op in blk.ops:
            for slot, names in op.inputs.items():
                for n in names:
                    if n:
                        uses.setdefault(n, []).append((blk.idx, op, slot))
    return uses


# ---------------------------------------------------------------------------
# activation calibration
# ---------------------------------------------------------------------------

def calibrate_activations(program, scope, act_names, feeds,
                          percentile=None, executor=None):
    """Run representative `feeds` (iterable of feed dicts) through the
    UNquantized program fetching each future-quantized matmul input,
    and return {var_name: static_scale}: absmax observer by default,
    percentile-P of |x| when `percentile` is given. The observer takes
    the MAX over batches. `executor=None` runs on the card."""
    act_names = sorted(set(act_names))
    if not act_names:
        return {}
    from .executor import Executor
    exe = executor or Executor()
    observed = dict.fromkeys(act_names, 0.0)
    n_feeds = 0
    for feed in feeds:
        n_feeds += 1
        vals = exe.run(program, feed=dict(feed), fetch_list=act_names,
                       scope=scope)
        for name, v in zip(act_names, vals):
            a = np.abs(np.asarray(v, dtype=np.float64))
            m = (float(np.percentile(a, float(percentile)))
                 if percentile is not None else float(a.max()))
            observed[name] = max(observed[name], m)
    if not n_feeds:
        raise ValueError("activation calibration needs at least one "
                         "representative feed batch")
    return {n: (m / 127.0 if m > 0 else 1.0 / 127.0)
            for n, m in observed.items()}


# ---------------------------------------------------------------------------
# the program transform
# ---------------------------------------------------------------------------

def quantize_program(program, scope, activations=False,
                     calibration_feeds=None, percentile=None,
                     min_elements=None, executor=None):
    """Quantize a pruned inference program's weights (and optionally
    activations) in a CLONE: returns (qprogram, qscope, report) — the
    original program and scope are untouched.

    report is JSON-safe: scheme/kernel ids, per-op records (original
    type, weight names, channel counts, scale ranges, original dtypes,
    static-vs-dynamic activation mode), byte accounting, and what was
    skipped and why.
    """
    from .executor import Scope

    if min_elements is None:
        min_elements = DEFAULT_MIN_ELEMENTS
    qprog = program.clone()
    block = qprog.global_block()
    qscope = Scope()
    for name in scope.keys():
        qscope.set(name, scope.get(name))

    # static activation scales come from observing the ORIGINAL program
    act_scales = {}
    if activations:
        act_names = []
        for op in block.ops:
            spec = _SPECS.get(op.type)
            if spec and spec.act_slot and op.inputs.get(spec.act_slot):
                act_names.append(op.inputs[spec.act_slot][0])
        act_scales = calibrate_activations(
            program, scope, act_names, calibration_feeds or (),
            percentile=percentile, executor=executor)

    host = {}                      # name -> numpy copy, read once

    def _w(name):
        if name not in host:
            host[name] = _host(scope.get(name))
        return host[name]

    done = {}                      # wname -> (scale_name, axes)
    records, skipped = [], []
    bytes_before = bytes_after = 0
    dequant_ops = 0

    # Use signatures are computed ONCE, over the PRISTINE op types,
    # before any rewrite: a weight shared by two eligible ops must see
    # both consumers as quantizable.
    def _use_sig(wname, uses):
        """The (slot, axes) signature every use of wname shares, or
        None when some use is not a quantizable weight slot (wrong slot,
        a sub-block op, or an op whose layout is ineligible)."""
        sig = None
        for blk_idx, op, slot in uses.get(wname, ()):
            spec = _SPECS.get(op.type)
            if blk_idx != 0 or spec is None or slot not in spec.weight_axes:
                return None
            w_by_slot = {
                s: _w(op.inputs[s][0])
                for s in spec.weight_axes
                if (op.inputs.get(s) or [None])[0] is not None
                and scope.has(op.inputs[s][0])}
            if not spec.eligible(op, w_by_slot):
                return None
            axes = tuple(spec.weight_axes[slot](op, _w(wname)))
            s = (slot, axes)
            if sig is None:
                sig = s
            elif sig != s:
                return None
        return sig

    _pre_uses = _weight_uses(qprog)
    use_sigs = {wname: _use_sig(wname, _pre_uses)
                for wname in _pre_uses
                if scope.has(wname)}

    for op_idx, op in enumerate(block.ops):
        spec = _SPECS.get(op.type)
        if spec is None:
            continue
        w_by_slot = {}
        for slot in spec.weight_axes:
            names = op.inputs.get(slot) or []
            if len(names) == 1 and scope.has(names[0]):
                w_by_slot[slot] = _w(names[0])
        if not w_by_slot:
            continue   # no persistable weight at all (e.g. act x act)
        if not spec.eligible(op, w_by_slot):
            skipped.append({"op": op_idx, "type": op.type,
                            "reason": "unsupported layout"})
            continue
        quantized_here = []
        for slot in spec.weight_axes:
            names = op.inputs.get(slot) or []
            if len(names) != 1:
                continue
            wname = names[0]
            var = block._find_var(wname)
            w = w_by_slot.get(slot)
            if (w is None or var is None or not var.persistable
                    or w.dtype.kind != "f" or w.size < min_elements):
                continue
            if use_sigs.get(wname) is None:
                skipped.append({"op": op_idx, "type": op.type,
                                "weight": wname,
                                "reason": "shared with a non-"
                                          "quantizable or mismatched "
                                          "consumer"})
                continue
            if wname in done:
                sname, _axes = done[wname]
            else:
                axes = tuple(spec.weight_axes[slot](op, w))
                q, scale = quantize_array(w, axes)
                sname = wname + _SCALE_SUFFIX
                ref = scope.get(wname)
                qscope.set(wname, _like(q, ref))
                qscope.set(sname, _like(scale, ref))
                var.dtype = "int8"
                block.create_var(name=sname, shape=list(scale.shape),
                                 dtype="float32", persistable=True)
                bytes_before += w.nbytes
                bytes_after += q.nbytes + scale.nbytes
                done[wname] = (sname, axes)
                records.append({
                    "weight": wname, "dtype": str(w.dtype),
                    "shape": list(w.shape),
                    "channels": int(scale.size),
                    "scale_min": float(scale.min()),
                    "scale_max": float(scale.max())})
            op.inputs[slot + "Scale"] = [sname]
            quantized_here.append([slot, wname, sname])
        if not quantized_here:
            continue
        act_mode = None
        if spec.act_slot:
            act_mode = "dynamic"
            xname = (op.inputs.get(spec.act_slot) or [None])[0]
            if xname in act_scales:
                aname = xname + _ACT_SUFFIX
                if not block.has_var(aname):
                    block.create_var(name=aname, shape=[1],
                                     dtype="float32", persistable=True)
                    qscope.set(aname, _like(
                        np.asarray([act_scales[xname]], np.float32),
                        scope.get(quantized_here[0][1])))
                op.inputs["ActScale"] = [aname]
                act_mode = "static"
        else:
            dequant_ops += 1
        orig_type = op.type
        op.type = "quant_" + orig_type
        op.attrs["quant_kernel"] = quant_ops.KERNEL_ID
        op.attrs["quant_original_type"] = orig_type
        op.attrs["quant_weights"] = quantized_here
        op.attrs["quant_w_dtype"] = "float32"
        op.attrs["quant_act"] = act_mode or ""
        records.append({"op": op_idx, "type": orig_type,
                        "activation": act_mode,
                        "weights": [wn for _s, wn, _sn
                                    in quantized_here]})
    qprog.bump()
    place_int8_weights(qprog, qscope)

    from . import flags as flags_mod
    report = {
        "scheme": SCHEME,
        "kernel": quant_ops.KERNEL_ID,
        # the flag and platform at quantize time (the reference records
        # what its exported artifacts bake); the port elects its core
        # per call from the tensor's device (quant_ops.resolve_int8_core)
        "int8_matmul": flags_mod.get("int8_matmul"),
        "baked_platform": "cuda" if torch.cuda.is_available() else "cpu",
        "activations": bool(activations),
        "percentile": percentile,
        "quantized_ops": sum(1 for r in records if "op" in r),
        "quantized_weights": len(done),
        "dequant_ops": dequant_ops,
        "bytes_before": int(bytes_before),
        "bytes_after": int(bytes_after),
        "bytes_saved": int(bytes_before - bytes_after),
        "ops": [r for r in records if "op" in r],
        "weights": [r for r in records if "weight" in r],
        "skipped": skipped,
    }
    _record_stats(report, source="quantize")
    return qprog, qscope, report


# ---------------------------------------------------------------------------
# load-time fallback (per op)
# ---------------------------------------------------------------------------

def has_quant_ops(program):
    return any(op.attrs.get("quant_kernel") is not None
               for blk in program.blocks for op in blk.ops)


def ensure_loadable(program, scope):
    """Walk a loaded program's quantized ops and dequantize — per op,
    in place — every one this runtime cannot execute (unknown quant op
    type or a kernel id from a newer quantizer). Warns per op, counts
    `quant.fallback_ops`, and never raises for a well-formed quantized
    model. Returns the number of ops that fell back."""

    def _supported(op):
        kernel = op.attrs.get("quant_kernel")
        return kernel is None or (kernel == quant_ops.KERNEL_ID
                                  and op_registry.has_op(op.type))

    # Dequantizing a weight in the SCOPE affects every consumer, so a
    # weight shared between a falling-back op and a still-supported
    # quant op drags the supported one down with it.
    forced = set()
    for blk in program.blocks:
        for op in blk.ops:
            if not _supported(op):
                for _slot, wname, _s in (op.attrs.get("quant_weights")
                                         or []):
                    forced.add(wname)
    fixed = 0
    for blk in program.blocks:
        for op in blk.ops:
            kernel = op.attrs.get("quant_kernel")
            if kernel is None:
                continue
            if _supported(op) and not (
                    forced & {w for _s, w, _n in
                              (op.attrs.get("quant_weights") or [])}):
                continue
            orig = op.attrs.get("quant_original_type")
            weights = op.attrs.get("quant_weights") or []
            if not orig or not weights:
                warnings.warn(
                    f"op {op.type!r} carries quant kernel {kernel!r} "
                    "this runtime does not support and no fallback "
                    "metadata — leaving it as-is (execution will "
                    "fail if this op is reached)", RuntimeWarning,
                    stacklevel=2)
                continue
            dtype = op.attrs.get("quant_w_dtype", "float32")
            for slot, wname, sname in weights:
                wq = scope.get(wname)
                sc = scope.get(sname)
                if wq is None or sc is None:
                    continue
                wq, sc = torch.as_tensor(wq), torch.as_tensor(sc)
                if wq.dtype == torch.int8:
                    # a weight shared by several falling-back ops is
                    # dequantized exactly once; quant_ops.dequantize is
                    # THE dequant definition
                    scope.set(wname, quant_ops.dequantize(
                        wq, sc.to(wq.device), dtype))
                var = blk._find_var(wname)
                if var is not None:
                    var.dtype = dtype
                op.inputs.pop(slot + "Scale", None)
            op.inputs.pop("ActScale", None)
            op.type = orig
            for a in quant_ops.META_ATTRS + ("quant_act",):
                op.attrs.pop(a, None)
            warnings.warn(
                f"quantized op {orig!r} uses kernel {kernel!r} which "
                "this runtime cannot execute — dequantized its "
                f"weights back to {dtype} and restored the f32 op "
                "(slower, near-f32 results)", RuntimeWarning,
                stacklevel=2)
            monitor.counter_inc("quant.fallback_ops")
            fixed += 1
    if fixed:
        program.bump()
    return fixed


# the int8-dot lowerings and the slot of their int8 weight
_INT8_DOT_SLOTS = {"quant_mul": "Y", "quant_matmul": "Y"}


def _on_card(w):
    return w.device.type == "cuda"


def place_int8_weights(program, scope):
    """Store every 2-D int8 weight that a quant_mul / quant_matmul of
    `program` reads, where it lies on a CUDA device, column-major: the
    view `w.t().contiguous().t()` (same shape [K, N], dtype and values;
    strides (1, K)), the K-major layout K6 reads without a transpose.
    Weights on the CPU, of another dtype or already column-major stay
    as they are. Returns the number of weights re-laid."""
    names = {n for blk in program.blocks for op in blk.ops
             if op.type in _INT8_DOT_SLOTS
             for n in op.inputs.get(_INT8_DOT_SLOTS[op.type]) or () if n}
    placed = 0
    for name in sorted(names):
        w = scope.get(name)
        if (not isinstance(w, torch.Tensor) or not _on_card(w)
                or w.dtype != torch.int8 or w.dim() != 2
                or quant_ops.is_column_major(w)):
            continue
        scope.set(name, w.t().contiguous().t())
        placed += 1
    return placed


# ---------------------------------------------------------------------------
# model-dir entry point
# ---------------------------------------------------------------------------

def _load_calibration_feeds(path, feed_names, batches=8):
    """An .npz of representative inputs, one array per feed name
    (first axis = samples), split into up to `batches` chunks so the
    observer sees several batch statistics instead of one."""
    with np.load(path) as data:
        missing = [n for n in feed_names if n not in data.files]
        if missing:
            raise ValueError(
                f"{path}: calibration npz lacks feed arrays "
                f"{missing} (has {sorted(data.files)})")
        arrays = {n: np.asarray(data[n]) for n in feed_names}
    rows = min(a.shape[0] for a in arrays.values())
    if rows < 1:
        raise ValueError(f"{path}: calibration arrays are empty")
    n_chunks = min(batches, rows)
    bounds = np.linspace(0, rows, n_chunks + 1, dtype=int)
    feeds = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            feeds.append({n: a[lo:hi] for n, a in arrays.items()})
    return feeds


def quantize_inference_model(model_dir, out_dir, activations=False,
                             calibration_feeds=None, percentile=None,
                             min_elements=None, executor=None):
    """Quantize a `save_inference_model` directory into the SAME
    layout (__model__.json with quant_* ops + params.npz holding int8
    weight blobs and their scales, plus the report as __quant__.json)
    for `serve --model_dir` and Executor users. `executor=None` loads
    (and calibrates) on the card. Returns (out_dir, report)."""
    from . import io as io_mod
    from .executor import Executor, Scope

    exe = executor or Executor()
    scope = Scope()
    program, feed_names, fetch_vars = io_mod.load_inference_model(
        model_dir, exe, scope=scope)
    feeds = None
    if activations:
        if not calibration_feeds:
            raise ValueError(
                "activations=True needs calibration_feeds=<f.npz>")
        feeds = _load_calibration_feeds(calibration_feeds, feed_names)
    qprog, qscope, report = quantize_program(
        program, scope, activations=activations,
        calibration_feeds=feeds, percentile=percentile,
        min_elements=min_elements, executor=exe)
    os.makedirs(out_dir, exist_ok=True)
    io_mod.save_inference_model(out_dir, feed_names, fetch_vars, exe,
                                main_program=qprog, scope=qscope)
    with open(os.path.join(out_dir, "__quant__.json"), "w") as f:
        json.dump(report, f)
    return out_dir, report


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_last = {}


def _record_stats(report, source):
    summary = {
        "source": source,
        "scheme": report.get("scheme"),
        "kernel": report.get("kernel"),
        "int8_matmul": report.get("int8_matmul"),
        "baked_platform": report.get("baked_platform"),
        "quantized_ops": report.get("quantized_ops", 0),
        "quantized_weights": report.get("quantized_weights", 0),
        "dequant_ops": report.get("dequant_ops", 0),
        "bytes_saved": report.get("bytes_saved", 0),
        "activations": report.get("activations", False),
    }
    with _lock:
        _last.clear()
        _last.update(summary)
    monitor.gauge_set("quant.quantized_ops", summary["quantized_ops"])
    monitor.gauge_set("quant.dequant_ops", summary["dequant_ops"])
    monitor.gauge_set("quant.bytes_saved", summary["bytes_saved"])
    return summary


def record_artifact_loaded(quant_meta):
    """Surface a loaded model's quantization report in the quant.*
    gauges and `stats()` without re-deriving it."""
    monitor.counter_inc("quant.artifacts_loaded")
    return _record_stats(quant_meta or {}, source="artifact")


def stats():
    """The last quantization/load summary (or {})."""
    with _lock:
        return dict(_last)
