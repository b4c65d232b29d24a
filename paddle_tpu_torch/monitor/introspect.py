"""Device & runtime introspection: memory, compile stats, FLOPs, debug vars.

The port's counterpart of `paddle_tpu/monitor/introspect.py`, on
`torch.cuda` where the reference reads PJRT:

  * `device_memory_stats()` — per-card live / peak / reserved bytes
    from the caching allocator (`torch.cuda.memory_allocated`,
    `max_memory_allocated`, `memory_stats`) and the card's capacity;
    on a machine without a card one CPU entry that reports no bytes
    (torch keeps no tally of its CPU tensors).
  * compile bookkeeping — the port compiles nothing per run; its two
    counterparts of a compile are a CUDA-graph capture of a serving rung
    (serving/graphs.py) and a kernel build with nvcc (_build.py). Both
    call `note_compile(signature, seconds)`; `compile_stats()` returns
    {signature: {count, total_s, last_s}}, capped at 128 signatures.
  * live MFU — `program_flops(program, feed)` is a static tally of the
    products a step runs, forward and gradient ops, from the Program's
    ops and their var shapes: the shapes the feed gives each var (every
    op run on meta tensors from the feed's shapes, so a sequence's
    padded time dim is the fed one), else the declared shape with the
    feed's batch dim in place of -1;
    `note_step_flops(flops, seconds)` joins it with a measured step into
    the `perf.*` gauges over `peak_flops()`.
  * `sample_device_gauges()` / `debug_vars(engine)` — the `device.*`
    gauges and the `GET /debug/vars` payload, with the reference's
    sections.
"""

from __future__ import annotations

import math
import os
import threading
import time

from . import registry as _registry

__all__ = ["device_memory_stats", "sample_device_gauges", "note_compile",
           "compile_stats", "debug_vars", "hbm_bytes_limit", "reset",
           "peak_flops", "program_flops", "program_op_costs",
           "note_step_flops", "perf_stats"]

_lock = threading.Lock()
_compiles: dict = {}      # signature -> {count, total_s, last_s}

# Signatures are bounded (FIFO eviction) so scrapes, snapshots and
# blackbox bundles cannot grow without limit; the cumulative admission
# count keeps growing past the cap, which reads as churn.
_MAX_SIGNATURES = 128
_total_signatures = 0


def note_compile(signature, seconds):
    """Record one build of `signature`: a CUDA-graph capture of a serving
    rung or an nvcc build of a kernel source."""
    global _total_signatures
    evicted = None
    with _lock:
        st = _compiles.get(signature)
        if st is None:
            if len(_compiles) >= _MAX_SIGNATURES:
                evicted = next(iter(_compiles))
                del _compiles[evicted]
            _total_signatures += 1
            st = _compiles[signature] = {"count": 0, "total_s": 0.0,
                                         "last_s": 0.0}
        st["count"] += 1
        st["total_s"] += float(seconds)
        st["last_s"] = float(seconds)
        total = _total_signatures
    if evicted is not None:
        _registry.global_registry().remove_gauge(
            f"executor.compile_last_s|signature={evicted}")
    _registry.gauge_set("executor.compiled_signatures", total)
    _registry.gauge_set(
        f"executor.compile_last_s|signature={signature}", seconds)


def compile_stats():
    with _lock:
        return {sig: dict(st) for sig, st in _compiles.items()}


# ---------------------------------------------------------------------------
# live MFU / throughput accounting
# ---------------------------------------------------------------------------

# Dense bf16 tensor-core peak FLOP/s per card, from NVIDIA's data sheets
# (H100 SXM5 / PCIe / NVL, A100, L40S, L4; the sparse figures are twice
# these). Matched as substrings of the lowercased
# torch.cuda.get_device_name(); most specific first. The H100 SXM number
# is the one PERF.md's bounds use.
_PEAK_FLOPS_BY_NAME = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("h200", 989e12),
    ("a100", 312e12),
    ("l40s", 362e12),
    ("l4", 121e12),
)
_UNKNOWN_CARD_PEAK = 989e12
# Off the card there is no meaningful peak: the reference's number keeps
# the MFU formula testable on the CPU, and the label says "cpu-smoke" so
# the value is never mistaken for an on-card one.
_CPU_SMOKE_PEAK = 197e12

_peak_cache = None          # (peak_flops, label) once detected
_perf: dict = {}            # last perf sample for /debug/vars


def _cuda_available():
    try:
        import torch
        return bool(torch.cuda.is_available())
    except Exception:        # noqa: BLE001 — a broken driver is "no card"
        return False


def peak_flops():
    """(peak_flops_per_sec, device_label). On the card the label is
    `torch.cuda.get_device_name(0)` and the peak its dense bf16 tensor
    peak from the name table; without a card ('cpu-smoke', the
    reference's 197e12)."""
    global _peak_cache
    if _peak_cache is not None:
        return _peak_cache
    if _cuda_available():
        import torch
        name = torch.cuda.get_device_name(0)
        probe = name.lower()
        peak = next((p for marker, p in _PEAK_FLOPS_BY_NAME
                     if marker in probe), _UNKNOWN_CARD_PEAK)
        _peak_cache = (peak, name)
    else:
        _peak_cache = (_CPU_SMOKE_PEAK, "cpu-smoke")
    return _peak_cache


# -- the static FLOP tally over Program ops --------------------------------
#
# Each product op counts 2 * (multiply-adds) of its dense math, the
# count the reference's auditor takes from the dot_general / conv eqns of
# its traced step (analysis/audit.py `_dot_flops`, `_conv_flops`). A grad
# op counts the products of its op's whole vjp, every input's gradient,
# as the reference's trace holds them. Attention counts the full Tq x Tk
# score matrix even when causal (the kernels skip the masked tiles; the
# reference's dots do not). The fused lm-head loss's gradient recomputes
# the logits: three products. transformer_stack counts every layer, and
# a recurrence (gru, lstm, lstmp, simple_rnn) every time step: the
# reference's scan body counts once (ROADMAP C12).


def _prod(dims):
    return math.prod(int(d) for d in dims)


def _mul_flops(xs, ys, attrs):
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    m, k = _prod(xs[:xn]), _prod(xs[xn:])
    n = _prod(ys[yn:])
    return 2 * m * k * n


def _conv_fwd(inp, flt, out, groups):
    # 2 * prod(out) * (kernel elements per output feature)
    return 2 * _prod(out) * _prod(flt[1:])


def _conv_grad(inp, flt, out, groups):
    # data gradient: a transposed conv over the input's positions; filter
    # gradient: one product a filter element per output position
    dgrad = 2 * _prod(inp) * (int(flt[0]) // max(int(groups), 1)) \
        * _prod(flt[2:])
    wgrad = 2 * _prod(flt) * int(out[0]) * _prod(out[2:])
    return dgrad + wgrad


def _attn_flops(q, k):
    # QK^T and PV: 2 products of B x Tq x Tk x H multiply-adds
    return 4 * int(q[0]) * int(q[1]) * int(k[1]) * int(q[2])


def _stack_flops(x, ins_shapes):
    B, T, H = (int(d) for d in x)
    wqkv, wproj = ins_shapes["Wqkv"], ins_shapes["Wproj"]
    wup, wdown = ins_shapes["Wup"], ins_shapes["Wdown"]
    L = int(wqkv[0])
    M = B * T
    per_layer = 2 * M * (_prod(wqkv[1:]) + _prod(wproj[1:])
                         + _prod(wup[1:]) + _prod(wdown[1:])) \
        + 4 * B * T * T * H
    return L * per_layer


def _matmul_flops(xs, ys, attrs, out):
    # 2 * prod(out) * K, K the contracted axis of X
    k = int(xs[-2] if attrs.get("transpose_X") and len(xs) > 1 else xs[-1])
    return 2 * _prod(out) * k


def _recurrence_flops(op_type, shapes):
    """The recurrent products of every time step: h [B, D] @ W [D, gD]
    (lstmp: r [B, P] @ W [P, 4D] and h [B, D] @ ProjWeight [D, P], plus
    the projection of H0 once)."""
    b, t = int(shapes["Input"][0]), int(shapes["Input"][1])
    w = shapes["Weight"]
    flops = 2 * b * t * _prod(w)
    if op_type == "lstmp":
        wp = shapes["ProjWeight"]
        flops += 2 * b * t * _prod(wp)
        if "H0" in shapes:
            flops += 2 * b * _prod(wp)
    return flops


def _op_flops(op_type, shapes, attrs, out_shapes):
    """FLOPs of one forward op from its input shapes ({slot: shape})."""
    if op_type in ("mul", "quant_mul"):
        return _mul_flops(shapes["X"], shapes["Y"], attrs)
    if op_type == "matmul":
        out = out_shapes.get("Out")
        if out is None:
            return 0
        return _matmul_flops(shapes["X"], shapes["Y"], attrs, out)
    if op_type in ("gru", "lstm", "lstmp", "simple_rnn"):
        return _recurrence_flops(op_type, shapes)
    if op_type == "sequence_conv":
        xs = shapes["X"]
        return 2 * int(xs[0]) * int(xs[1]) * _prod(shapes["Filter"])
    if op_type == "quant_matmul":
        xs, ys = shapes["X"], shapes["Y"]
        return 2 * _prod(xs[:-1]) * int(xs[-1]) * int(ys[-1])
    if op_type == "scaled_dot_product_attention":
        return _attn_flops(shapes["Q"], shapes["K"])
    if op_type == "fused_lm_head_xent":
        xs, ws = shapes["X"], shapes["W"]
        return 2 * _prod(xs[:-1]) * int(xs[-1]) * int(ws[-1])
    if op_type in ("conv2d", "depthwise_conv2d", "quant_conv2d",
                   "quant_depthwise_conv2d"):
        out = out_shapes.get("Output")
        if out is None:
            return 0
        return _conv_fwd(shapes["Input"], shapes["Filter"], out,
                         attrs.get("groups", 1))
    if op_type == "conv2d_transpose":
        # the transpose of a conv: the forward conv's data gradient
        inp, flt = shapes["Input"], shapes["Filter"]
        return 2 * _prod(inp) * _prod(flt[1:])
    if op_type in ("transformer_stack", "quant_transformer_stack"):
        if "Wqkv" not in shapes:
            return 0
        return _stack_flops(shapes["X"], shapes)
    return _tail_flops(op_type, shapes, attrs, out_shapes)


def _tail_flops(op_type, shapes, attrs, out_shapes):
    """The product ops of the corpus's tail, by the reference's traced
    eqns: conv3d_transpose is an input-dilated conv over the whole
    output (2 x out x Cin x kernel), dynamic_conv2d a conv a sample,
    bilinear_tensor_product the outer product x y^T then its
    contraction with W, nce one row product a sample (true and
    negative), hsigmoid one a tree level."""
    if op_type == "conv3d":
        out = out_shapes.get("Output")
        return 0 if out is None else _conv_fwd(
            shapes["Input"], shapes["Filter"], out, attrs.get("groups", 1))
    if op_type == "conv3d_transpose":
        out, flt = out_shapes.get("Output"), shapes["Filter"]
        return 0 if out is None else \
            2 * _prod(out) * int(flt[0]) * _prod(flt[2:])
    if op_type == "dynamic_conv2d":
        out = out_shapes.get("Out")
        return 0 if out is None else 2 * _prod(out) * int(
            attrs["num_channels"]) * int(attrs["kh"]) * int(attrs["kw"])
    if op_type == "bilinear_tensor_product":
        (b, m), n = shapes["X"], int(shapes["Y"][-1])
        s = int(shapes["Weight"][0])
        return 2 * int(b) * int(m) * n * (1 + s)
    if op_type == "conv_shift":
        (b, m), n = shapes["X"], int(shapes["Y"][-1])
        return 2 * int(b) * int(m) * n
    if op_type == "nce":
        b, d = shapes["Input"]
        n = int(shapes["Label"][-1]) + int(attrs["num_neg_samples"])
        return 2 * int(b) * int(d) * n
    if op_type == "hsigmoid":
        b, d = shapes["X"]
        levels = int(math.floor(math.log2(2 * int(attrs["num_classes"])
                                          - 1)))
        return 2 * int(b) * int(d) * levels
    return 0


_GRAD_FACTOR = {"mul": 2, "scaled_dot_product_attention": 2,
                "fused_lm_head_xent": 3, "transformer_stack": 2,
                "conv2d_transpose": 2, "matmul": 2, "gru": 2, "lstm": 2,
                "lstmp": 2, "simple_rnn": 2, "sequence_conv": 2,
                "bilinear_tensor_product": 2, "conv_shift": 2, "nce": 2,
                "hsigmoid": 2}


def _grad_flops(op_type, shapes, attrs, out_shapes):
    if op_type in ("conv2d", "depthwise_conv2d", "conv3d"):
        out = out_shapes.get("Output")
        if out is None:
            return 0
        return _conv_grad(shapes["Input"], shapes["Filter"], out,
                          attrs.get("groups", 1))
    if op_type == "conv3d_transpose":
        # the input's cotangent (a strided conv) and the filter's (the
        # forward's count)
        return 2 * _prod(shapes["Input"]) * _prod(shapes["Filter"][1:]) \
            + _op_flops(op_type, shapes, attrs, out_shapes)
    if op_type == "dynamic_conv2d":
        out = out_shapes.get("Out")
        if out is None:
            return 0
        x, flt = shapes["X"], shapes["Filter"]
        o, kh, kw = (int(attrs[k]) for k in ("num_filters", "kh", "kw"))
        positions = _prod(out) // (int(x[0]) * o)
        return 2 * _prod(x) * o * kh * kw + 2 * _prod(flt) * positions
    factor = _GRAD_FACTOR.get(op_type)
    if factor is None:
        return 0
    return factor * _op_flops(op_type, shapes, attrs, out_shapes)


def _var_shape(block, name, dyn, fed=None):
    if fed:
        base = name[:-len("@GRAD")] if name.endswith("@GRAD") else name
        if base in fed:
            return fed[base]
    v = block._find_var(name)
    if v is None or v.shape is None:
        return None
    return tuple(dyn if int(s) < 0 else int(s) for s in v.shape)


def _fed_shapes(block, feed):
    """{var: shape} under `feed`: the feeds' own shapes, and each
    forward op's outputs from its lowering run on meta tensors (no data,
    no device) over its inputs' fed or declared shapes, in program
    order. An op whose inputs are not all known, or whose lowering
    refuses meta tensors, adds nothing."""
    import numpy as np
    import torch
    from ..ops import registry as op_registry
    shapes = {n: tuple(int(d) for d in np.shape(v))
              for n, v in (feed or {}).items()}
    if not shapes:
        return shapes
    ctx = op_registry._MetaCtx()
    for op in block.ops:
        if op.type.endswith("_grad") or not op_registry.has_op(op.type):
            continue
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if not n:
                    continue
                v = block._find_var(n)
                shape = shapes.get(n)
                if shape is None and v is not None and v.shape is not None \
                        and all(int(d) >= 0 for d in v.shape):
                    shape = tuple(int(d) for d in v.shape)
                if shape is None or v is None:
                    ins = None
                    break
                vals.append(torch.empty(shape, device="meta",
                                        dtype=op_registry.torch_dtype(
                                            v.dtype)))
            if ins is None:
                break
            if vals:
                ins[slot] = vals
        if ins is None:
            continue
        try:
            with torch.no_grad():
                outs = op_registry.get_op(op.type).lowering(
                    ctx, ins, dict(op.attrs))
        except Exception:      # noqa: BLE001 — the tally must not break
            continue
        for slot, names in op.outputs.items():
            for n, t in zip(names, outs.get(slot) or ()):
                if n and isinstance(t, torch.Tensor):
                    shapes[n] = tuple(int(d) for d in t.shape)
    return shapes


def _var_bytes(block, name, dyn, fed=None):
    import numpy as np
    shape = _var_shape(block, name, dyn, fed)
    v = block._find_var(name)
    if shape is None or v is None or v.dtype is None:
        return 0
    try:
        return _prod(shape) * np.dtype(str(v.dtype)).itemsize
    except TypeError:
        return 2 * _prod(shape)     # bfloat16 (numpy has no such dtype)


def _feed_batch(feed):
    import numpy as np
    for v in (feed or {}).values():
        shape = np.shape(v)
        if shape:
            return int(shape[0])
    return 1


def _src_flops(program, block, src, grad, dyn, fed):
    """The FLOPs of forward op `src` (of its gradient with `grad`), with
    the ops of its sub-blocks: a recurrent_group's step block counts
    once a time step, a while body once (its iteration count is not
    static), both ifelse branches and every switch case once each."""
    shapes = {slot: _var_shape(block, names[0], dyn, fed)
              for slot, names in src.inputs.items() if names and names[0]}
    out_shapes = {slot: _var_shape(block, names[0], dyn, fed)
                  for slot, names in src.outputs.items()
                  if names and names[0]}
    flops = 0
    if all(s is not None for s in shapes.values()):
        try:
            fn = _grad_flops if grad else _op_flops
            flops = int(fn(src.type, shapes, src.attrs, out_shapes))
        except (KeyError, IndexError, TypeError, ValueError):
            flops = 0
    from ..ops.registry import sub_block_idxs
    idxs = sub_block_idxs(src)
    if not idxs:
        return flops
    sub = sum(_src_flops(program, program.blocks[i], o, grad, dyn, None)
              for i in idxs for o in program.blocks[i].ops)
    steps = 1
    if src.type == "recurrent_group":
        seq = shapes.get("Seq")
        steps = int(seq[1]) if seq is not None and len(seq) > 1 else 1
    return flops + steps * sub


def program_op_costs(program, feed=None, block=None):
    """[(op_idx, op_type, flops, bytes)] for every op of the program's
    global block (a control-flow op with its sub-blocks' ops, as
    `_src_flops` counts them): the static tally behind `program_flops` and
    deviceprof's per-scope costs. Shapes are the vars' declared shapes
    with the feed's batch dim in place of -1; bytes are the op's input
    and output var bytes."""
    block = block if block is not None else program.global_block()
    dyn = _feed_batch(feed)
    fed = _fed_shapes(block, feed)
    by_id = {op.id: op for op in block.ops}
    out = []
    for idx, op in enumerate(block.ops):
        grad = op.type.endswith("_grad") and "fwd_op_id" in op.attrs
        src = by_id.get(op.attrs["fwd_op_id"]) if grad else op
        flops = 0
        if src is not None:
            flops = _src_flops(program, block, src, grad, dyn, fed)
        nbytes = sum(_var_bytes(block, n, dyn, fed)
                     for names in list(op.inputs.values())
                     + list(op.outputs.values()) for n in names if n)
        out.append((idx, op.type, flops, nbytes))
    return out


def program_flops(program, feed=None, fetch_list=None, scope=None,
                  executor=None):
    """Static per-step FLOP tally of `program` (no device work): the
    numerator of perf.mfu. `fetch_list`, `scope` and `executor` are
    accepted for the reference's signature; the tally reads only the
    Program and the feed's batch size."""
    return int(sum(f for _, _, f, _ in program_op_costs(program, feed)))


def note_step_flops(flops, seconds):
    """Join a static per-step FLOP tally with one measured step wall time
    into the perf.* gauges:

        perf.flops_per_sec        = flops / seconds
        perf.mfu|device=<label>   = flops / (seconds * peak_flops)
        perf.step_flops           = flops
        perf.peak_flops|device=…  = the denominator used

    Returns the mfu value, or None for degenerate inputs."""
    flops = int(flops or 0)
    seconds = float(seconds)
    if flops <= 0 or seconds <= 0:
        return None
    peak, label = peak_flops()
    fps = flops / seconds
    mfu = fps / peak
    _registry.gauge_set("perf.flops_per_sec", fps)
    _registry.gauge_set("perf.step_flops", float(flops))
    _registry.gauge_set(f"perf.peak_flops|device={label}", peak)
    _registry.gauge_set(f"perf.mfu|device={label}", mfu)
    with _lock:
        _perf.update(step_flops=flops, step_time_s=seconds,
                     flops_per_sec=fps, mfu=mfu, peak_flops=peak,
                     device=label)
    return mfu


def perf_stats():
    """Latest perf sample (the /debug/vars 'perf' section); {} before
    any note_step_flops call."""
    with _lock:
        return dict(_perf)


# -- device memory ---------------------------------------------------------

_MEMORY_STAT_KEYS = ("allocated_bytes.all.current",
                     "allocated_bytes.all.peak",
                     "reserved_bytes.all.current",
                     "reserved_bytes.all.peak",
                     "num_alloc_retries", "num_ooms")


def device_memory_stats():
    """Per-card memory view from torch's caching allocator; never raises
    (introspection must work from a dying process)."""
    try:
        import torch
        if not torch.cuda.is_available():
            return [{"device": "cpu", "platform": "cpu",
                     "source": "none (torch keeps no CPU tally)"}]
        out = []
        for i in range(torch.cuda.device_count()):
            entry = {"device": f"cuda:{i}", "platform": "gpu",
                     "kind": torch.cuda.get_device_name(i),
                     "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                     "peak_bytes_in_use": int(
                         torch.cuda.max_memory_allocated(i)),
                     "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                     "bytes_limit": int(
                         torch.cuda.get_device_properties(i).total_memory),
                     "source": "torch.cuda"}
            stats = torch.cuda.memory_stats(i)
            entry["memory_stats"] = {k: int(stats[k])
                                     for k in _MEMORY_STAT_KEYS
                                     if k in stats}
            out.append(entry)
        return out
    except Exception as e:   # noqa: BLE001 — the driver may be gone
        return [{"error": f"{type(e).__name__}: {e}"}]


def hbm_bytes_limit():
    """Smallest card capacity in bytes, or None without a card."""
    limits = [e["bytes_limit"] for e in device_memory_stats()
              if "bytes_limit" in e]
    return min(limits) if limits else None


def sample_device_gauges():
    """Push device memory into the registry as labeled gauges plus
    totals (callers pick the cadence: /debug/vars samples on demand)."""
    stats = device_memory_stats()
    total_in_use = 0
    total_peak = 0
    for entry in stats:
        dev = entry.get("device")
        if dev is None or "bytes_in_use" not in entry:
            continue
        in_use = int(entry["bytes_in_use"])
        total_in_use += in_use
        _registry.gauge_set(f"device.mem_in_use_bytes|device={dev}",
                            in_use)
        if "peak_bytes_in_use" in entry:
            peak = int(entry["peak_bytes_in_use"])
            total_peak += peak
            _registry.gauge_set(f"device.mem_peak_bytes|device={dev}",
                                peak)
    _registry.gauge_set("device.mem_in_use_bytes_total", total_in_use)
    if total_peak:
        _registry.gauge_set("device.mem_peak_bytes_total", total_peak)
    return stats


def _persistent_cache_stats():
    """The reference's persistent XLA compile cache has no counterpart:
    kernels build once per source hash into build/paddle_tpu_torch/ and
    CUDA graphs are captured per process."""
    return {"enabled": False,
            "reason": "no persistent compile cache in the port: kernel "
                      "libraries are cached by source hash under "
                      "build/paddle_tpu_torch/, CUDA graphs are captured "
                      "per process"}


def debug_vars(engine=None):
    """The GET /debug/vars payload: one JSON object with everything a
    dashboard or a human with curl needs to explain a replica."""
    from .. import flags
    from . import blackbox
    if _registry.enabled():
        device = sample_device_gauges()
    else:
        device = device_memory_stats()
    out = {
        "pid": os.getpid(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "metrics": _registry.snapshot(),
        "flags": flags.snapshot(),
        "device_memory": device,
        "compile_cache": compile_stats(),
        "persistent_compile_cache": _persistent_cache_stats(),
        "flight_recorder": {"records": len(blackbox.recorder()),
                            "capacity": blackbox.recorder().capacity,
                            "dropped": blackbox.recorder().dropped},
        "perf": perf_stats(),
    }
    try:
        from ..reader import pipeline as _pipeline
        feed = _pipeline.feed_stats()
        if feed is not None:
            out["feed"] = feed
    except Exception as e:   # noqa: BLE001 — diagnostics only
        out["feed"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        # the quantization story of the loaded model (quant.py)
        from .. import quant as _quant
        qs = _quant.stats()
        if qs:
            out["quant"] = qs
    except Exception as e:   # noqa: BLE001 — diagnostics only
        out["quant"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        # windowed time-series + SLO table when the sampler is running
        # (metrics_sample_s flag); absent otherwise
        from . import timeseries as _ts
        ts = _ts.stats()
        if ts is not None:
            out["timeseries"] = ts
    except Exception as e:   # noqa: BLE001 — diagnostics only
        out["timeseries"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        # sampled device-time attribution (profile_sample_n flag);
        # absent when no sampler is active
        from . import deviceprof as _dp
        dp = _dp.stats()
        if dp is not None:
            out["deviceprof"] = dp
    except Exception as e:   # noqa: BLE001 — diagnostics only
        out["deviceprof"] = {"error": f"{type(e).__name__}: {e}"}
    if engine is not None:
        out["engine"] = engine.stats()
    return out


def reset():
    """Tests: forget compile bookkeeping and perf samples."""
    global _total_signatures, _peak_cache
    with _lock:
        _compiles.clear()
        _total_signatures = 0
        _perf.clear()
        _peak_cache = None
