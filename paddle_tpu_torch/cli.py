"""Command line of the port.

    python -m paddle_tpu_torch serve --model_dir DIR \
        [--max_batch_size 16] [--batch_timeout_ms 2] [--buckets 1,2,4,8]
    python -m paddle_tpu_torch serve --artifact m.pdmodel
    python -m paddle_tpu_torch serve --generate --artifact lm.pdmodel
        [--port 8080] [--host 127.0.0.1] [--device cpu]
        [--fleet http://router:port --replica_id r0 --fleet_ttl 5]
    python -m paddle_tpu_torch route (--model_dir DIR | --artifact F)
        [--replicas 3] [--retry_budget 2] [--probe_interval 0.5]
        [--autoscale --min_replicas 1 --max_replicas 4]
    python -m paddle_tpu_torch route --targets http://a:1,http://b:2

Telemetry: `--set flag=value,...` sets any flag (as the env spelling
PADDLE_TPU_<FLAG> would), e.g. `--set metrics_sample_s=1,trace_path=
/tmp/t.json,blackbox_dir=/tmp/bb,profile_sample_n=16`; `--metrics_path
FILE` dumps the registry there at exit (`monitor.maybe_dump()`, also
when serving fails). `GET /debug/vars` serves the introspection payload.

`serve --model_dir` serves a `save_inference_model` directory (f32, or
int8 from `quant.quantize_inference_model`; either package's) through
the micro-batching engine behind `POST /v1/infer`. `serve --artifact`
serves an artifact written by the JAX package: an LM artifact
(`paddle_tpu.io.export_lm_artifact`, detected by its meta's `lm`
section) through the continuous-batching engine behind `POST
/v1/generate`, any other through `InferenceEngine.from_artifact` (it
must embed its program: `export_inference_artifact(...,
embed_program=True)`). Both run on the card unless `--device cpu`; a
replica that cannot reach the card exits non-zero. The HTTP server
binds before warmup (`/healthz` answers "booting" until every rung has
run once); SIGTERM drains the in-flight requests and exits 0. With
`--fleet` the replica registers with a fleet router after it binds,
pushes its readiness after warmup, heartbeats its lease every ttl/3 and
deregisters before it drains; its time-series sampler defaults on at
1 s (the router merges its windowed quantiles) unless the
metrics_sample_s flag was set.

`route` runs the fleet router (serving/fleet.py). By default it spawns
and supervises `--replicas` `serve --fleet` subprocesses of
`--model_dir` or `--artifact` (crash restarts with backoff, rolling
swaps through `POST /fleet/swap`), on the card unless `--device cpu`;
`--targets` routes over an externally managed fleet instead.
`--autoscale` runs the AutoscaleController (serving/autoscale.py) in
the router process. SIGTERM stops the autoscaler, drains the replicas
and exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

__all__ = ["main"]


def _log(msg):
    print(f"[paddle_tpu_torch] {msg}", file=sys.stderr, flush=True)


def _parser():
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    p.add_argument("job", choices=["serve", "route"])
    src = p.add_mutually_exclusive_group()
    src.add_argument("--model_dir",
                     help="[serve|route] a save_inference_model "
                          "directory (json): one-shot serving, POST "
                          "/v1/infer")
    src.add_argument("--artifact",
                     help="[serve|route] an artifact of the JAX package: "
                          "an LM artifact (export_lm_artifact) serves "
                          "POST /v1/generate, an embedded-program "
                          "inference artifact POST /v1/infer")
    p.add_argument("--generate", action="store_true",
                   help="serve a generative-LM artifact (implied by "
                        "--artifact)")
    p.add_argument("--max_batch_size", type=int, default=None,
                   help="--model_dir: admission bound and largest rung "
                        "(default: the serving_max_batch_size flag)")
    p.add_argument("--batch_timeout_ms", type=float, default=None,
                   help="--model_dir: how long a batch is held open "
                        "(default: the serving_batch_timeout_ms flag)")
    p.add_argument("--buckets", default=None,
                   help="--model_dir: comma-separated batch ladder "
                        "(default: powers of two)")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=8080,
                   help="bind port (0 = ephemeral, printed at start)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu — no silent fallback")
    p.add_argument("--queue_limit", type=int, default=None,
                   help="bounded-queue capacity (default: the "
                        "serving_queue_limit flag)")
    p.add_argument("--read_timeout_s", type=float, default=None,
                   help="per-connection socket read timeout (default: "
                        "the serving_read_timeout_s flag)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every rung before reporting ready")
    p.add_argument("--set", dest="set_flags", default="",
                   help="comma-separated flag=value pairs, e.g. "
                        "metrics_sample_s=1,trace_path=/tmp/t.json "
                        "(the PADDLE_TPU_<FLAG> env spelling)")
    p.add_argument("--metrics_path", default=None,
                   help="write the metrics registry here at exit "
                        "(.json snapshot or .jsonl lines)")
    p.add_argument("--fleet", default=None,
                   help="[serve] register this replica with a fleet "
                        "router at http://host:port and heartbeat a TTL "
                        "lease (deregisters before draining)")
    p.add_argument("--replica_id", default=None,
                   help="[serve] this replica's fleet identity "
                        "(default: replica-<pid>)")
    p.add_argument("--fleet_ttl", type=float, default=5.0,
                   help="[serve|route] replica lease TTL seconds; a "
                        "replica that stops heartbeating is ejected "
                        "this soon")
    p.add_argument("--advertise_host", default=None,
                   help="[serve --fleet] host the ROUTER should reach "
                        "this replica at (default: --host, or the "
                        "machine's resolved address when --host is a "
                        "wildcard bind like 0.0.0.0)")
    p.add_argument("--replicas", type=int, default=3,
                   help="[route] replica subprocesses to spawn and "
                        "supervise")
    p.add_argument("--targets", default="",
                   help="[route] comma-separated replica base URLs to "
                        "route over INSTEAD of spawning replicas "
                        "(externally managed fleet; members are probed "
                        "but never restarted)")
    p.add_argument("--retry_budget", type=int, default=2,
                   help="[route] extra failover hops allowed per "
                        "request after the first attempt")
    p.add_argument("--probe_interval", type=float, default=0.5,
                   help="[route] lease sweep + /healthz probe cadence "
                        "in seconds")
    p.add_argument("--breaker_threshold", type=int, default=3,
                   help="[route] consecutive hop failures that open a "
                        "replica's circuit breaker")
    p.add_argument("--breaker_cooldown", type=float, default=5.0,
                   help="[route] seconds an open breaker waits before "
                        "half-opening one trial request")
    p.add_argument("--autoscale", action="store_true",
                   help="[route] run the AutoscaleController inside "
                        "the router: the fleet sizes itself off its "
                        "own /fleet/dashboard signals, adding/removing "
                        "supervised replica slots with drain-safe "
                        "scale-down (spawn mode only; --replicas is "
                        "the starting size)")
    p.add_argument("--min_replicas", type=int, default=None,
                   help="[route --autoscale] fleet size floor "
                        "(default: the autoscale_min_replicas flag)")
    p.add_argument("--max_replicas", type=int, default=None,
                   help="[route --autoscale] fleet size ceiling "
                        "(default: the autoscale_max_replicas flag)")
    p.add_argument("--autoscale_mode", default=None,
                   choices=["reactive", "predictive"],
                   help="[route --autoscale] reactive (hysteresis over "
                        "queue/SLO signals) or predictive (load-model "
                        "scale-up off measured per-rung device times; "
                        "default: the autoscale_mode flag)")
    p.add_argument("--scale_cooldown_s", type=float, default=None,
                   help="[route --autoscale] override BOTH per-"
                        "direction cooldowns with one value (defaults: "
                        "the autoscale_up_cooldown_s / "
                        "autoscale_down_cooldown_s flags)")
    return p


def _parse_kv(text):
    out = {}
    for item in (text or "").split(","):
        if not item.strip():
            continue
        if "=" not in item:
            raise SystemExit(f"--set expects flag=value, got {item!r}")
        k, v = item.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _serve(args):
    from . import flags

    if not (args.model_dir or args.artifact):
        raise SystemExit("serve needs --model_dir=saved_model_dir or "
                         "--artifact=m.pdmodel")
    for k, v in _parse_kv(args.set_flags).items():
        flags.set_flag(k, v)
    if args.metrics_path:
        flags.set_flag("metrics_path", args.metrics_path)
    # GET /metrics is part of the serve contract: recording is on
    flags.set_flag("metrics", True)
    if args.fleet and "metrics_sample_s" not in flags.snapshot() \
            and "PADDLE_TPU_METRICS_SAMPLE_S" not in os.environ:
        # a fleet replica defaults its sampler on (1 s): the router's
        # latency merge reads the replica's windowed quantiles from
        # /debug/vars. An explicit metrics_sample_s (env or --set) wins.
        flags.set_flag("metrics_sample_s", 1.0)
    # resolve the telemetry flags now: trace_path starts the ambient
    # trace and metrics_sample_s the sampler (their side effects)
    flags.get("trace_path")
    flags.get("metrics_sample_s")
    from . import monitor
    try:
        return _serve_engine(args)
    finally:
        # written even when serving raises; a dump failure never masks
        # the job's own exception
        try:
            monitor.maybe_dump()
        except OSError as e:
            _log(f"metrics dump failed: {e}")


def _wait_for_sigterm():
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    except KeyboardInterrupt:
        pass


def _engine_of(args):
    """(engine, is_lm, what) for the serve job's source."""
    from .serving.engine import EngineConfig, InferenceEngine

    buckets = ([int(b) for b in args.buckets.split(",") if b]
               if args.buckets else None)
    cfg = EngineConfig(max_batch_size=args.max_batch_size,
                       batch_timeout_ms=args.batch_timeout_ms,
                       queue_limit=args.queue_limit, buckets=buckets)
    if args.model_dir:
        if args.generate:
            raise SystemExit(
                "--generate needs an LM artifact (--artifact); "
                f"{args.model_dir} is a one-shot inference model (it "
                "serves without --generate)")
        from . import io as io_mod
        from .executor import Executor, Scope
        if not os.path.isdir(args.model_dir):
            raise SystemExit(f"--model_dir not found: {args.model_dir}")
        exe = Executor(args.device)
        scope = Scope()
        program, feed_names, fetch_vars = io_mod.load_inference_model(
            args.model_dir, exe, scope=scope)
        engine = InferenceEngine.from_program(
            program, feed_names, fetch_vars, executor=exe, scope=scope,
            config=cfg)
        return engine, False, f"device={exe.device}"
    from .io import read_artifact_meta
    if not os.path.exists(args.artifact):
        raise SystemExit(f"--artifact file not found: {args.artifact}")
    meta = read_artifact_meta(args.artifact)
    if not meta.get("lm"):
        if args.generate:
            raise SystemExit(
                "--generate needs an export_lm_artifact file; "
                f"{args.artifact} is not one (one-shot inference "
                "artifacts serve without --generate)")
        engine = InferenceEngine.from_artifact(args.artifact, config=cfg,
                                               device=args.device)
        return engine, False, "from_artifact"
    from .serving.lm import GenerationConfig, GenerationEngine
    config = GenerationConfig.from_meta(
        meta["lm"]["serving"],
        **({"queue_limit": args.queue_limit}
           if args.queue_limit is not None else {}))
    engine = GenerationEngine.from_artifact(args.artifact, config=config,
                                            device=args.device)
    return engine, True, (
        f"device={engine.device}, slots={config.max_slots}, "
        f"prefill_batch={config.prefill_batch}, "
        f"max_prompt={config.max_prompt_len}, "
        f"max_new={config.max_new_tokens}, paged={config.paged}")


def _advertised_host(args):
    """A wildcard bind (0.0.0.0 / ::) is not a routable address (the
    router would probe itself), so advertise a reachable one."""
    adv = args.advertise_host or args.host
    if adv in ("0.0.0.0", "::", ""):
        import socket
        try:
            adv = socket.gethostbyname(socket.gethostname())
        except OSError:
            adv = "127.0.0.1"
        _log(f"advertising {adv} to the fleet router (wildcard bind; "
             "override with --advertise_host)")
    return adv


def _serve_engine(args):
    from .serving.fleet import FleetRegistrar
    from .serving.http import make_server

    engine, lm, what = _engine_of(args)
    replica_id = args.replica_id or f"replica-{os.getpid()}"
    # readiness is gated on warmup: the server binds first (/healthz?live
    # answers and a router can watch the boot), /healthz says "booting"
    engine.set_ready(False)
    server = make_server(engine, host=args.host, port=args.port,
                         read_timeout_s=args.read_timeout_s,
                         replica_id=replica_id)
    threading.Thread(target=server.serve_forever,
                     name="paddle-tpu-torch-http", daemon=True).start()
    port = server.server_address[1]
    registrar = None
    if args.fleet:
        registrar = FleetRegistrar(
            args.fleet, replica_id,
            f"http://{_advertised_host(args)}:{port}", engine,
            ttl_s=args.fleet_ttl).start()
    if args.no_warmup:
        engine.set_ready(True)
    else:
        _log(f"warmed {'rungs' if lm else 'buckets'} {engine.warmup()}")
    if registrar is not None:
        registrar.notify()     # push readiness now, not next heartbeat
    source = args.model_dir or args.artifact
    if lm:
        _log(f"serving LM {source} on http://{args.host}:{port} "
             f"({what}) — POST /v1/generate")
    else:
        cfg = engine.config
        _log(f"serving {source} on http://{args.host}:{port} "
             f"({what}, max_batch={cfg.max_batch_size}, "
             f"timeout={cfg.batch_timeout_ms}ms, "
             f"queue_limit={cfg.queue_limit}, buckets={list(cfg.buckets)})"
             " — POST /v1/infer")
    _wait_for_sigterm()
    _log("draining...")
    if registrar is not None:
        # deregister first: the router stops routing new requests here
        # before the engine drains the admitted ones
        registrar.stop(deregister=True)
    server.shutdown()
    engine.shutdown(drain=True)
    st = engine.stats()
    if lm:
        _log(f"served {st['completed']} generations / {st['tokens']} "
             f"tokens in {st['decode_steps']} decode steps "
             f"(shed={st['shed']}, rejected={st['rejected']})")
    else:
        _log(f"served {st['completed']} requests in {st['batches']} "
             f"batches (shed={st['shed']}, rejected={st['rejected']}, "
             f"errors={st['errors']})")
    return 0


def _route(args):
    """The fleet router over supervised `serve --fleet` replicas (or
    --targets); see the module docstring."""
    from . import flags, monitor
    from .serving.fleet import FleetRouter, ReplicaSupervisor, RouterConfig

    for k, v in _parse_kv(args.set_flags).items():
        flags.set_flag(k, v)
    flags.set_flag("metrics", True)
    rcfg = RouterConfig(retry_budget=args.retry_budget,
                        probe_interval_s=args.probe_interval,
                        breaker_threshold=args.breaker_threshold,
                        breaker_cooldown_s=args.breaker_cooldown)
    router = FleetRouter(config=rcfg, host=args.host, port=args.port,
                         read_timeout_s=args.read_timeout_s)
    supervisor = None
    source = args.model_dir or args.artifact
    if args.targets:
        for i, url in enumerate(u for u in args.targets.split(",") if u):
            out = router.register(f"target-{i}", url.strip())
            if out.get("status") != "ok":
                router.shutdown()
                raise SystemExit(f"bad --targets entry: {out['detail']}")
        _log(f"routing over {len(router.status()['replicas'])} static "
             f"targets on {router.url}")
    else:
        if not source:
            router.shutdown()
            raise SystemExit("route needs --model_dir=DIR or "
                             "--artifact=m.pdmodel (to spawn replicas) "
                             "or --targets=url1,url2")
        if not os.path.exists(source):
            router.shutdown()
            raise SystemExit(f"model not found: {source}")
        replica_args = []
        for name in ("max_batch_size", "batch_timeout_ms", "queue_limit",
                     "buckets", "device"):
            val = getattr(args, name)
            if val is not None:
                replica_args.append(f"--{name}={val}")
        supervisor = ReplicaSupervisor(
            router, source, args.replicas, host=args.host,
            ttl_s=args.fleet_ttl, replica_args=replica_args)
        router.supervisor = supervisor
    autoscaler = None
    if args.autoscale:
        if supervisor is None:
            router.shutdown()
            raise SystemExit(
                "--autoscale needs a supervised (spawn-mode) fleet — "
                "a --targets fleet is externally managed")
        from .serving.autoscale import AutoscaleConfig, AutoscaleController
        acfg = AutoscaleConfig.from_flags(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            mode=args.autoscale_mode,
            up_cooldown_s=args.scale_cooldown_s,
            down_cooldown_s=args.scale_cooldown_s)
        autoscaler = AutoscaleController(router, supervisor, acfg)
        router.autoscaler = autoscaler
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    # the boot wait sits inside the guard: Ctrl-C during a slow warmup
    # must still stop the spawned replica processes
    try:
        if supervisor is not None:
            supervisor.start()
            _log(f"fleet router on {router.url}: spawning "
                 f"{args.replicas} replicas of {source} "
                 f"(retry_budget={rcfg.retry_budget}, "
                 f"breaker={rcfg.breaker_threshold}@"
                 f"{rcfg.breaker_cooldown_s}s)")
            if supervisor.wait_all_ready(timeout=300):
                _log("fleet ready")
            else:
                _log("warning: not every replica became ready "
                     "within 300s")
        if autoscaler is not None:
            autoscaler.start()
            _log(f"autoscaler on ({autoscaler.config.mode}): "
                 f"[{autoscaler.config.min_replicas}, "
                 f"{autoscaler.config.max_replicas}] replicas, "
                 f"tick every {autoscaler.config.interval_s}s — "
                 f"GET {router.url}/fleet/autoscale")
        while not stop.is_set():
            stop.wait(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        _log("stopping fleet...")
        if autoscaler is not None:
            autoscaler.stop()
        if supervisor is not None:
            supervisor.stop()
        router.shutdown()
    snap = monitor.snapshot()["counters"]
    _log("fleet counters: " + json.dumps(
        {k: v for k, v in sorted(snap.items())
         if k.startswith("fleet.") or k.startswith("autoscale.")}))
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.job == "serve":
        return _serve(args)
    return _route(args)
