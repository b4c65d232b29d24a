"""Deterministic fault injection: every recovery path gets exercised.

The port's copy of `paddle_tpu/resilience/faults.py`, with the same
`PADDLE_TPU_FAULTS` / `faults` flag grammar, so one schedule drives
either package. A schedule looks like::

    PADDLE_TPU_FAULTS="step:7:RuntimeError,ckpt_save:1:crash"

The port fires the sites `step`, `ckpt_save`, `ckpt_swap`,
`ckpt_load`, `fleet_forward` and `fleet_probe` (serving/fleet.py); the
others (`rpc`, `master_*`) belong to the reference's elastic master,
which is not ported, and are accepted so that a spec stays valid in both
packages.

Spec grammar — comma-separated `site:trigger:kind` items:

  site     where the fault fires (each site is a `faults.fire(site)`
           call in the runtime):
             step       the Trainer's supervised step, before the
                        executor runs (index = the trainer's 0-based
                        global step)
             ckpt_save  io.save_checkpoint, after the temp directory is
                        fully written but before the atomic swap
             ckpt_swap  io.save_checkpoint, between the two renames of
                        the swap (the half-swapped window: old
                        checkpoint in `.old`, target dir missing)
             ckpt_load  io.load_checkpoint, before reading
             rpc        elastic.MasterClient, per RPC attempt
             master_rpc elastic MasterServer handler, per received
                        request (server-side failures: the request is
                        rejected or — `partition` — the connection is
                        dropped without an answer)
             master_crash
                        elastic MasterServer deadline sweep, per sweep
                        iteration: `crash` here kills the master process
                        abruptly (no final snapshot) — the restart-from-
                        snapshot path's trigger
             fleet_forward
                        serving FleetRouter, per forwarded hop (before
                        the connection is opened): `partition` here
                        models the router losing the network to its
                        replicas — every hop fails for the window, the
                        breakers open, requests shed typed
             fleet_probe
                        serving FleetRouter health prober, per replica
                        probe
  trigger  when it fires:
             N          at index N exactly, once (for `step` N is the
                        global step; elsewhere the 1-based call count)
             N=         at index N exactly, EVERY time it comes around
                        (never consumed — a deterministically bad
                        batch that NaNs on every replay)
             N+         at every index >= N (a permanently-down master)
             pX         each call with probability X% from the
                        injector's seeded RNG (chaos mode,
                        deterministic per seed)
  kind     what is raised:
             crash      SimulatedCrash — a BaseException modelling a
                        process kill: no retry/anomaly handler may
                        catch it, it unwinds like SIGKILL
             nan        FloatingPointError("injected NaN anomaly...")
                        — classified like a tripped NaN guard
             partition | partition(S)
                        PartitionFault — a network partition: the
                        triggering call AND every later call at the same
                        site raise for a window of S seconds (default
                        1.0), modelling connections dropped/hung until
                        the partition heals; only the triggering call is
                        logged/counted, window drops are free
             RuntimeError | OSError | IOError | ConnectionError |
             TimeoutError | ValueError
                        that exception, tagged "injected transient
                        fault" (is_transient treats RuntimeError/OSError
                        kinds as retryable)

Deterministic triggers are consumed on firing, so a retried operation
succeeds on its next attempt — exactly the transient-failure shape the
retry/rollback machinery exists for. Injections are recorded on the
injector (`injector.injected`) and counted as
`resilience.faults_injected`, so tests can assert that the counters
match the schedule exactly.
"""

from __future__ import annotations

import random
import re
import threading
import time

from .. import monitor

__all__ = ["FaultInjector", "SimulatedCrash", "PartitionFault",
           "FaultSpecError", "get_injector", "fire", "reset"]

SITES = ("step", "ckpt_save", "ckpt_swap", "ckpt_load", "rpc",
         "master_rpc", "master_crash", "fleet_forward", "fleet_probe")


class SimulatedCrash(BaseException):
    """A modelled process kill (SIGKILL / machine loss): inherits
    BaseException so no retry loop or anomaly handler can swallow it —
    it unwinds the whole stack the way a real crash erases the process.
    Harnesses (tests, the chip smoke) catch it at top level and
    then *restart*, which is the recovery path being proven."""


class PartitionFault(ConnectionError):
    """An injected network partition: the connection is dropped (or
    hung, which a read timeout turns into the same thing) without a
    response. ConnectionError so client-side retry classification treats
    it as transient when it crosses a process boundary."""


class FaultSpecError(ValueError):
    """Malformed PADDLE_TPU_FAULTS spec."""


_EXC_KINDS = {
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
}


def _parse_trigger(text, item):
    text = text.strip()
    try:
        if text.startswith("p"):
            pct = float(text[1:])
            if not 0 < pct <= 100:
                raise ValueError
            return ("p", pct / 100.0)
        if text.endswith("+"):
            return ("ge", int(text[:-1]))
        if text.endswith("="):
            return ("always", int(text[:-1]))
        return ("eq", int(text))
    except ValueError:
        raise FaultSpecError(
            f"bad trigger {text!r} in fault spec item {item!r} — want an "
            "index N (once), N= (every encounter), N+ (every call from "
            "N on), or pX (X% chance)"
        ) from None


def parse_spec(spec):
    """`site:trigger:kind,...` -> list of fault dicts (see module doc)."""
    faults = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) != 3:
            raise FaultSpecError(
                f"bad fault spec item {item!r} — want site:trigger:kind")
        site, trigger, kind = (p.strip() for p in parts)
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} in {item!r} — known sites: "
                f"{SITES}")
        window = None
        if kind.startswith("partition"):
            m = re.fullmatch(r"partition(?:\(([0-9]+(?:\.[0-9]+)?)\))?",
                             kind)
            if m is None:
                raise FaultSpecError(
                    f"bad partition kind {kind!r} in {item!r} — want "
                    "partition or partition(seconds)")
            window = float(m.group(1)) if m.group(1) else 1.0
            kind = "partition"
        elif kind not in ("crash", "nan") and kind not in _EXC_KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {item!r} — known kinds: "
                f"crash, nan, partition[(seconds)], {sorted(_EXC_KINDS)}")
        faults.append({"site": site, "trigger": _parse_trigger(trigger,
                                                               item),
                       "kind": kind, "window": window, "fired": False})
    return faults


class FaultInjector:
    """Seeded, schedule-driven failure source.

    `fire(site, index=None)` raises the scheduled fault when `index`
    matches a trigger for `site` (auto-counted 1-based per site when the
    caller passes no index). Silent and near-free otherwise — an empty
    schedule short-circuits immediately.
    """

    def __init__(self, spec="", seed=0):
        self.spec = spec or ""
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._faults = parse_spec(spec)
        self._counts = {}
        self._partition_until = {}   # site -> wall-clock end of window
        # `master_rpc` fires from concurrent ThreadingTCPServer handler
        # threads: the count/fired/window read-modify-writes must be
        # atomic or a scheduled trigger can fire twice (or be skipped)
        self._lock = threading.Lock()
        self.injected = []     # (site, index, kind) log, in firing order

    def fire(self, site, index=None):
        if not self._faults:
            return
        with self._lock:
            # inside an open partition window every call at the site
            # fails the same way (connection dropped); window drops are
            # not logged or counted — only the triggering call was
            # scheduled
            until = self._partition_until.get(site)
            if until is not None:
                if time.time() < until:
                    raise PartitionFault(
                        f"injected partition open at {site} "
                        f"({until - time.time():.2f}s left)")
                del self._partition_until[site]
            if index is None:
                self._counts[site] = self._counts.get(site, 0) + 1
                index = self._counts[site]
            index = int(index)
            for f in self._faults:
                if f["site"] != site:
                    continue
                mode, arg = f["trigger"]
                if mode == "eq":
                    hit = index == arg and not f["fired"]
                elif mode == "always":
                    hit = index == arg
                elif mode == "ge":
                    hit = index >= arg
                else:   # probabilistic, seeded
                    hit = self._rng.random() < arg
                if hit:
                    f["fired"] = True
                    self.injected.append((site, index, f["kind"]))
                    monitor.counter_inc("resilience.faults_injected")
                    raise self._make(f, site, index)

    def _make(self, f, site, index):
        kind = f["kind"]
        if kind == "crash":
            return SimulatedCrash(f"injected crash at {site}:{index}")
        if kind == "nan":
            return FloatingPointError(
                f"injected NaN anomaly at {site}:{index}")
        if kind == "partition":
            self._partition_until[site] = time.time() + f["window"]
            return PartitionFault(
                f"injected partition at {site}:{index} "
                f"({f['window']}s window)")
        return _EXC_KINDS[kind](
            f"injected transient fault ({kind}) at {site}:{index}")

    def counts_by_kind(self):
        out = {}
        for _, _, kind in self.injected:
            out[kind] = out.get(kind, 0) + 1
        return out

    def __repr__(self):
        return f"FaultInjector({self.spec!r}, seed={self.seed})"


# ---------------------------------------------------------------------------
# Ambient injector: runtime sites call `faults.fire(site)`; the schedule
# comes from the `faults` flag (PADDLE_TPU_FAULTS). Re-reading the flag
# keys the cached injector by spec string, so flags.set_flag/reset give
# a fresh injector per schedule while one schedule keeps its occurrence
# counts across all sites for the whole run.
# ---------------------------------------------------------------------------

_cache = {"spec": None, "injector": None}


def get_injector():
    from .. import flags
    spec = flags.get("faults")
    if spec != _cache["spec"]:
        _cache["spec"] = spec
        _cache["injector"] = FaultInjector(spec) if spec else None
    return _cache["injector"]


def fire(site, index=None):
    """The runtime's injection hook: no-op (one dict probe) without a
    configured schedule."""
    inj = get_injector()
    if inj is not None:
        inj.fire(site, index)


def reset():
    """Drop the cached ambient injector (tests: re-arm the same spec)."""
    _cache["spec"] = None
    _cache["injector"] = None
