"""Model-health telemetry: grad norms, update ratios, loss EMA.

The port's counterpart of `paddle_tpu/monitor/health.py`. Two halves:

  * **The step's reductions** (`StepHealth`, driven by the executor):
    when the fetch list names the reserved `__health.*__` fetches, the
    executor computes

        __health.grad_norm__      global L2 norm over every gradient
                                  the optimizer consumes (f32 accum)
        __health.param_norm__     global L2 norm over the post-update
                                  parameters
        __health.update_ratios__  per-parameter ‖Δw‖/(‖w‖+eps), the
                                  effective-learning-rate signal, as one
                                  f32 vector aligned with
                                  `param_grad_pairs` order

    The reference appends these reductions to its compiled step (no
    extra dispatch); here they are extra eager launches of the same
    step. No parameter is copied ahead of the step: each parameter's
    pre-update value is taken just before the op that writes it (a
    clone only when that op updates in place) and reduced right after,
    so at most one parameter's copy is alive at a time. Norms accumulate
    in f32 whatever the tensors' dtype. A SelectedRows gradient (an
    is_sparse embedding's) is reduced over its merged rows: duplicate
    rows summed first, as the reference's densified norm, never
    Σ values² over the raw lookups. With no health fetch the executor
    runs none of this.

  * **`HealthMonitor`** (host side, owned by the Trainer via
    `Trainer(health_metrics=True)`): splits the fetched health values
    off each step, keeps the loss EMA and a short history, exports the
    `health.*` gauges, hands a per-step snapshot to trainer events,
    contributes a `health` section to every blackbox bundle, and
    explains anomalies for the policy ("grad_norm jumped 40.0x at step
    N").
"""

from __future__ import annotations

import collections
import threading

from . import registry as _registry

__all__ = ["PREFIX", "GRAD_NORM", "PARAM_NORM", "UPDATE_RATIOS",
           "FETCHES", "is_health_fetch", "param_grad_pairs",
           "check_fetch_names", "StepHealth", "HealthMonitor",
           "activate", "current_section"]

# Reserved fetch-variable names: block var names never start with
# "__health.", and they are how the executor knows to run the reductions.
PREFIX = "__health."
GRAD_NORM = "__health.grad_norm__"
PARAM_NORM = "__health.param_norm__"
UPDATE_RATIOS = "__health.update_ratios__"
FETCHES = (GRAD_NORM, PARAM_NORM, UPDATE_RATIOS)

_EPS = 1e-12

# per-parameter gauges are bounded: the first _MAX_PARAM_GAUGES params
# get individual series (aggregates and the blackbox section carry all)
_MAX_PARAM_GAUGES = 32


def is_health_fetch(name):
    return isinstance(name, str) and name.startswith(PREFIX)


def check_fetch_names(names):
    """The health fetches among `names`; an unknown `__health.*` name
    raises KeyError, as the reference's executor does."""
    health = [n for n in names if is_health_fetch(n)]
    unknown = set(health) - set(FETCHES)
    if unknown:
        raise KeyError(
            f"unknown health fetch name(s) {sorted(unknown)}; "
            f"valid: {list(FETCHES)}")
    return health


def param_grad_pairs(program, block=None):
    """[(param_name, grad_name)] the program's optimizer ops consume,
    in op order, deduped by param. Prefers the list the optimizer
    stamped at `apply_gradients` time (`program._health_param_grads`);
    falls back to scanning the block's optimizer ops (programs built
    without the in-tree Optimizer)."""
    block = block if block is not None else program.global_block()
    stamped = getattr(program, "_health_param_grads", None)
    if stamped:
        # both vars must exist in THIS block, and the MOST RECENT stamp
        # per param wins
        pairs = [(p, g) for p, g in stamped
                 if block._find_var(p) is not None
                 and block._find_var(g) is not None]
        if pairs:
            latest = _dedupe(reversed(pairs))
            latest.reverse()            # keep stamp order for display
            return latest
    from ..ops import registry as op_registry
    pairs = []
    for op in block.ops:
        if not op_registry.has_op(op.type):
            continue
        if not op_registry.get_op(op.type).is_optimizer:
            continue
        params = op.inputs.get("Param") or []
        grads = op.inputs.get("Grad") or []
        if params and grads and params[0] and grads[0]:
            pairs.append((params[0], grads[0]))
    return _dedupe(pairs)


def _dedupe(pairs):
    seen = set()
    out = []
    for p, g in pairs:
        if p not in seen:
            seen.add(p)
            out.append((p, g))
    return out


def _dense_rows(val):
    """A gradient's values for its norm: a SelectedRows' merged rows
    (each touched row's summed gradient: the norm of its dense form),
    a tensor as it is (the reference's `_dense_f32`)."""
    from ..selected_rows import is_selected_rows, merge_rows
    return merge_rows(val)[1] if is_selected_rows(val) else val


def _norms(tensors):
    """f32 L2 norm of each tensor, as one [n] f32 tensor: one
    multi-tensor launch where torch offers it."""
    import torch
    if not tensors:
        return None
    ts = [_dense_rows(t).detach() for t in tensors]
    if all(t.dtype == torch.float32 for t in ts):
        try:
            return torch.stack(torch._foreach_norm(ts, 2))
        except (AttributeError, RuntimeError):
            pass
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in ts])


class StepHealth:
    """The eager health reductions of one executor run.

    `before(op, env, in_place)` runs just before each op and `after(op,
    env)` just after it; `finish(env)` puts every name of FETCHES into
    env. Only ops that write a watched parameter do any work."""

    def __init__(self, program, block):
        self.pairs = param_grad_pairs(program, block)
        self._watched = {p for p, _ in self.pairs}
        self._pending = {}      # param -> its pre-update tensor
        self._ratios = {}       # param -> f32 scalar tensor

    def _written(self, op):
        return [n for names in op.outputs.values() for n in names
                if n in self._watched]

    def before(self, op, env, in_place):
        for p in self._written(op):
            old = env.get(p)
            if old is None or p in self._ratios:
                continue
            # an op that writes a new tensor leaves the old one intact;
            # an in-place update needs the one copy
            self._pending[p] = old.detach().clone() if in_place else old

    def after(self, op, env):
        import torch
        for p in self._written(op):
            old = self._pending.pop(p, None)
            new = env.get(p)
            if old is None or new is None:
                continue
            d = torch.linalg.vector_norm((new.detach().float()
                                          - old.float()),
                                         dtype=torch.float32)
            base = torch.linalg.vector_norm(old, dtype=torch.float32)
            self._ratios[p] = d / (base + _EPS)

    def finish(self, env, device):
        import torch
        zero = torch.zeros((), dtype=torch.float32, device=device)
        grads = [env[g] for _, g in self.pairs if env.get(g) is not None]
        params = [env[p] for p, _ in self.pairs if env.get(p) is not None]
        gn = _norms(grads)
        pn = _norms(params)
        env[GRAD_NORM] = (torch.sqrt(torch.sum(gn * gn)) if gn is not None
                          else zero)
        env[PARAM_NORM] = (torch.sqrt(torch.sum(pn * pn))
                           if pn is not None else zero)
        ratios = [self._ratios[p] for p, _ in self.pairs
                  if p in self._ratios]
        env[UPDATE_RATIOS] = (torch.stack(ratios) if ratios
                              else torch.zeros((0,), dtype=torch.float32,
                                               device=device))


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Per-trainer model-health bookkeeping over the fetched step
    reductions. Thread-compatible (one trainer thread observes; the
    blackbox provider reads a snapshot dict under the lock)."""

    def __init__(self, program, ema_alpha=0.98, history=64,
                 jump_factor=10.0):
        self.pairs = param_grad_pairs(program)
        self.param_names = [p for p, _ in self.pairs]
        # no optimizer ops -> nothing to watch: the monitor disables
        # itself instead of fetching vacuous zeros every step
        self.enabled = bool(self.pairs)
        self.ema_alpha = float(ema_alpha)
        self.jump_factor = float(jump_factor)
        self.loss_ema = None
        self.last = None                     # latest per-step snapshot
        self._grad_hist = collections.deque(maxlen=int(history))
        self._lock = threading.Lock()

    def fetch_names(self):
        """Extra fetch vars the trainer appends to its fetch list —
        empty when there is nothing to watch."""
        return list(FETCHES) if self.enabled else []

    def observe(self, step, loss, values):
        """Consume one step's fetched health values (aligned with
        `fetch_names()` order) + the loss the trainer already fetched.
        Updates the EMA/history and exports the health.* gauges (gauge
        writes are free when the metrics flag is off)."""
        if not self.enabled:
            return None
        import numpy as np
        grad_norm = float(np.asarray(values[0]))
        param_norm = float(np.asarray(values[1]))
        ratios = np.asarray(values[2], dtype=np.float64).ravel()
        loss = float(loss)
        with self._lock:
            if self.loss_ema is None:
                self.loss_ema = loss
            else:
                a = self.ema_alpha
                self.loss_ema = a * self.loss_ema + (1.0 - a) * loss
            snap = {
                "step": int(step),
                "loss": loss,
                "loss_ema": self.loss_ema,
                "grad_norm": grad_norm,
                "param_norm": param_norm,
                "update_ratio_max": (float(ratios.max())
                                     if ratios.size else 0.0),
                "update_ratio_mean": (float(ratios.mean())
                                      if ratios.size else 0.0),
            }
            if ratios.size:
                i = int(ratios.argmax())
                if i < len(self.param_names):
                    snap["update_ratio_argmax"] = self.param_names[i]
            self.last = snap
            # only FINITE grad norms feed the jump baseline: one NaN
            # step must not poison every later comparison
            if np.isfinite(grad_norm):
                self._grad_hist.append(grad_norm)
        _registry.gauge_set("health.grad_norm", grad_norm)
        _registry.gauge_set("health.param_norm", param_norm)
        _registry.gauge_set("health.loss_ema", snap["loss_ema"])
        _registry.gauge_set("health.update_ratio_max",
                            snap["update_ratio_max"])
        _registry.gauge_set("health.update_ratio_mean",
                            snap["update_ratio_mean"])
        _registry.counter_inc("health.steps")
        for name, r in list(zip(self.param_names,
                                ratios))[:_MAX_PARAM_GAUGES]:
            _registry.gauge_set(f"health.update_ratio|param={name}",
                                float(r))
        return snap

    def explain(self):
        """One-line anomaly context from the latest step: how the
        gradient norm compares to its running mean, plus the hottest
        parameter — what the anomaly policy's report carries instead of
        a bare loss number. Safe before any observation."""
        with self._lock:
            snap = dict(self.last) if self.last else None
            hist = list(self._grad_hist)
        if snap is None:
            return "health: no steps observed yet"
        gn = snap["grad_norm"]
        # baseline excludes the current step when it is in the history
        base = hist[:-1] if (hist and hist[-1] == gn) else hist
        parts = []
        if base:
            mean = sum(base) / len(base)
            if mean > 0 and gn > self.jump_factor * mean:
                parts.append(
                    f"grad_norm jumped {gn / mean:.1f}x at step "
                    f"{snap['step']} ({gn:.4g} vs running mean "
                    f"{mean:.4g})")
            else:
                ratio = gn / mean if mean > 0 else float("inf")
                parts.append(
                    f"grad_norm {gn:.4g} at step {snap['step']} "
                    f"({ratio:.2f}x the running mean {mean:.4g})")
        else:
            parts.append(f"grad_norm {gn:.4g} at step {snap['step']} "
                         "(no history yet)")
        hot = snap.get("update_ratio_argmax")
        parts.append(f"update_ratio_max={snap['update_ratio_max']:.3g}"
                     + (f" ({hot})" if hot else ""))
        parts.append(f"loss_ema={snap['loss_ema']:.6g}")
        return "; ".join(parts)

    def section(self):
        """The blackbox-bundle `health` section: latest snapshot plus
        the recent grad-norm history (the lead-up a post-mortem needs)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "params": self.param_names,
                "last": dict(self.last) if self.last else None,
                "loss_ema": self.loss_ema,
                "grad_norm_history": list(self._grad_hist),
            }


# the monitor whose section rides into blackbox bundles (latest
# activated wins — one trainer per process is the operational case)
_active = None


def activate(mon):
    global _active
    _active = mon
    return mon


def current_section():
    """`health` section for blackbox.dump — None when no monitor is
    active (the bundle then simply lacks the section)."""
    if _active is None:
        return None
    return _active.section()
