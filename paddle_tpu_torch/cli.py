"""Command line of the port.

    python -m paddle_tpu_torch train --config=cfg.py [--save_dir=out]
        [--num_passes=1] [--log_period=100] [--config_args=k=v,...]
        [--device cpu]
    python -m paddle_tpu_torch test --config=cfg.py \
        --init_model_path=out/pass-00000
    python -m paddle_tpu_torch time --config=cfg.py --num_batches=20
    python -m paddle_tpu_torch checkgrad --config=cfg.py
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

`train`, `test`, `time` and `checkgrad` are the legacy trainer's jobs
(the reference's TrainerMain, `paddle_tpu/cli.py`): the config runs
through `trainer_config_helpers.parse_config`, its data comes from the
`define_py_data_sources2` provider module, pass snapshots land in
`SAVE_DIR/pass-%05d`, and the log lines and JSON records are printed to
stdout exactly as the reference prints them. They run on the card
unless `--device cpu`; with no card they raise. The reference's
`--use_tpu` is `--device` here, and its `--mesh` / `--master` are not
offered (one card, no elastic master yet).

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
    p.add_argument("job", choices=["train", "test", "time", "checkgrad",
                                   "serve", "route"])
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
    _legacy_arguments(p)
    return p


def _legacy_arguments(p):
    """The arguments of the legacy jobs (the reference's flags of the
    same names)."""
    p.add_argument("--config", default=None,
                   help="[train|test|time|checkgrad] legacy config file "
                        "(executed by parse_config)")
    p.add_argument("--config_args", default="",
                   help="comma-separated k=v handed to get_config_arg")
    p.add_argument("--save_dir", default=None,
                   help="[train] pass snapshots land in "
                        "SAVE_DIR/pass-%%05d; also holds the resume "
                        "checkpoint")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--start_pass", type=int, default=0)
    p.add_argument("--init_model_path", default=None,
                   help="load persistables from this dir before running")
    p.add_argument("--log_period", type=int, default=100)
    p.add_argument("--test_period", type=int, default=0,
                   help="0 = test on all test data at the end of each "
                        "pass; N>0 = test every N batches")
    p.add_argument("--num_batches", type=int, default=10,
                   help="[time] batches to measure")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--feed_workers", type=int, default=None,
                   help="[train] input-pipeline convert worker threads "
                        "(default: the feed_workers flag)")
    p.add_argument("--feed_prefetch_depth", type=int, default=None,
                   help="[train] device-side prefetch queue depth "
                        "(default: the feed_prefetch_depth flag)")
    p.add_argument("--anomaly_policy", default=None,
                   choices=["raise", "skip_batch", "rollback"],
                   help="[train] what a NaN-guard trip / loss spike "
                        "does (resilience.AnomalyPolicy)")
    p.add_argument("--max_skips", type=int, default=3,
                   help="[train] consecutive-skip budget for "
                        "--anomaly_policy=skip_batch")
    p.add_argument("--preemption_checkpoint", action="store_true",
                   help="[train] SIGTERM/SIGINT checkpoints at the next "
                        "step boundary and exits 0")


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


# ---------------------------------------------------------------------------
# the legacy trainer's jobs (the reference's TrainerMain analog)
# ---------------------------------------------------------------------------

def _out(msg):
    """A log line or JSON record of a legacy job: stdout, as the
    reference prints it, so the same scripts read both packages."""
    print(msg, flush=True)


def _place(args):
    """The job's place: the card unless `--device cpu` (raises with no
    card)."""
    from ._device import resolve_device
    from .framework import CPUPlace, CUDAPlace
    dev = resolve_device(args.device)
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def _load_config(args):
    """The job's config, parsed into fresh default programs (a job owns
    them, also when `main` runs twice in one process)."""
    from .framework import reset_default_programs
    from .trainer_config_helpers import parse_config
    reset_default_programs()
    if not args.config:
        raise SystemExit("--config is required for this job")
    cfg_path = os.path.abspath(args.config)
    if not os.path.exists(cfg_path):
        raise SystemExit(f"--config file not found: {cfg_path}")
    rec = parse_config(cfg_path, config_args=_parse_kv(args.config_args))
    if not rec.outputs:
        raise SystemExit("config produced no outputs() — nothing to train")
    return rec


def _provider_readers(rec, config_dir):
    """Resolve the config's define_py_data_sources2 into (train_reader,
    test_reader) sample readers via the @provider module (the
    PyDataProvider2 path, reference PyDataProvider2.cpp:195, minus the
    embedded interpreter), imported against this package's
    data_provider."""
    from .trainer_config_helpers import import_provider_module
    ds = rec.data_sources
    if not ds:
        return None, None
    prov = getattr(import_provider_module(ds["module"], config_dir),
                   ds["obj"])

    def file_list(spec):
        if spec is None:
            return None
        path = spec if os.path.isabs(spec) else os.path.join(config_dir,
                                                             spec)
        if os.path.exists(path) and path.endswith(".list"):
            with open(path) as f:
                return [ln.strip() for ln in f if ln.strip()]
        return [path]   # a single data file is its own list

    def mk(files, is_train):
        if files is None:
            return None
        bound = prov.bind(ds.get("args"), file_list=files,
                          is_train=is_train)
        return bound.reader_from_list(files)

    return (mk(file_list(ds.get("train_list")), True),
            mk(file_list(ds.get("test_list")), False))


def _job_train(args):
    import time

    from . import event, flags, io, resilience
    from . import reader as reader_mod
    from .trainer import Trainer

    rec = _load_config(args)
    cost, = rec.outputs[:1]
    place = _place(args)
    if args.seed is not None:
        rec.program.seed = args.seed
    # pipeline knobs land in the flags so every feed of the job (train
    # loop, per-batch test sweeps) picks them up
    if args.feed_workers is not None:
        flags.set_flag("feed_workers", args.feed_workers)
    if args.feed_prefetch_depth is not None:
        flags.set_flag("feed_prefetch_depth", args.feed_prefetch_depth)
    anomaly = (resilience.AnomalyPolicy(
                   args.anomaly_policy,
                   max_consecutive_skips=args.max_skips)
               if args.anomaly_policy else None)
    trainer = Trainer(cost=cost, optimizer=rec.create_optimizer(),
                      place=place,
                      checkpoint_dir=(os.path.join(args.save_dir, "ckpt")
                                      if args.save_dir else None),
                      anomaly_policy=anomaly,
                      preemption_checkpoint=args.preemption_checkpoint)
    # FLAGS_start_pass: begin at this pass index (a resume checkpoint
    # further along wins); an override past the checkpoint starts its
    # pass at batch 0
    if args.start_pass > trainer._start_pass:
        trainer._start_pass = args.start_pass
        trainer._start_batch = 0

    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    try:
        train_sampler, test_sampler = _provider_readers(rec, cfg_dir)
        if train_sampler is None:
            raise SystemExit(
                "config has no define_py_data_sources2 train source")
        bs = rec.batch_size or 32
        train_reader = reader_mod.batch(train_sampler, bs, drop_last=True)
        test_reader = (reader_mod.batch(test_sampler, bs, drop_last=False)
                       if test_sampler else None)
        feed_order = rec.feed_order

        t_state = {"t0": time.perf_counter(), "seen": 0}

        def handler(ev):
            if isinstance(ev, event.EndIteration):
                t_state["seen"] += bs
                if (args.log_period
                        and (ev.batch_id + 1) % args.log_period == 0):
                    dt = time.perf_counter() - t_state["t0"]
                    _out(f"Pass {ev.pass_id}, Batch {ev.batch_id + 1}, "
                         f"Cost {ev.cost:.6f}, "
                         f"{t_state['seen'] / dt:.1f} samples/sec")
                if (args.test_period and test_reader is not None
                        and (ev.batch_id + 1) % args.test_period == 0):
                    res = trainer.test(test_reader, feed_order)
                    _out(f"Pass {ev.pass_id}, Batch {ev.batch_id + 1}, "
                         f"test cost {res.cost:.6f}")
            elif isinstance(ev, event.EndPass):
                msg = f"Pass {ev.pass_id} done"
                if getattr(ev, "test_result", None) is not None:
                    msg += f"; test cost {ev.test_result.cost:.6f}"
                _out(msg)
                if args.save_dir:
                    pass_dir = os.path.join(args.save_dir,
                                            f"pass-{ev.pass_id:05d}")
                    trainer.save_params(pass_dir)
                    _out(f"saved parameters to {pass_dir}")

        if args.init_model_path:
            io.load_persistables(trainer.exe, args.init_model_path,
                                 rec.program, scope=trainer.scope)
            _out(f"initialised model from {args.init_model_path}")

        # test_period == 0: sweep the test data at the end of every pass
        trainer.train(reader=train_reader, num_passes=args.num_passes,
                      feed_order=feed_order, event_handler=handler,
                      test_reader=(test_reader if args.test_period == 0
                                   else None))
    except resilience.PreemptionShutdown as e:
        # graceful preemption: the checkpoint (if --save_dir) is on
        # disk; exit 0 so the scheduler restarts rather than fails
        _out(f"preemption shutdown: {e}")
    return 0


def _job_test(args):
    from . import io
    from . import reader as reader_mod
    from .trainer import Trainer

    rec = _load_config(args)
    cost, = rec.outputs[:1]
    trainer = Trainer(cost=cost, optimizer=None, place=_place(args))
    if args.init_model_path:
        io.load_persistables(trainer.exe, args.init_model_path,
                             rec.program, scope=trainer.scope)
    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    train_sampler, test_sampler = _provider_readers(rec, cfg_dir)
    sampler = test_sampler or train_sampler
    if sampler is None:
        raise SystemExit("config has no data sources to test on")
    bs = rec.batch_size or 32
    res = trainer.test(reader_mod.batch(sampler, bs, drop_last=False),
                       rec.feed_order)
    out = {"cost": res.cost}
    for name, val in zip(res.metric_names, res.metrics):
        out[name] = val
    _out(json.dumps({"job": "test", **out}))
    return 0


def _job_time(args):
    """Trainer::time: the training time a batch on the provider's data,
    forward, backward and update together. Each timed step fetches its
    cost (a device -> host read), so the clock covers the card's work."""
    import time

    import numpy as np

    from . import reader as reader_mod
    from .trainer import Trainer

    rec = _load_config(args)
    cost, = rec.outputs[:1]
    trainer = Trainer(cost=cost, optimizer=rec.create_optimizer(),
                      place=_place(args))
    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    train_sampler, _ = _provider_readers(rec, cfg_dir)
    if train_sampler is None:
        raise SystemExit("config has no train data source")
    bs = rec.batch_size or 32
    batches = []
    it = reader_mod.batch(train_sampler, bs, drop_last=True)()
    for _ in range(args.num_batches):
        try:
            batches.append(next(it))
        except StopIteration:
            break
    if not batches:
        raise SystemExit("train source yielded no full batch")
    feeder = trainer._feeder(rec.feed_order)
    # warmup: the first run builds what later runs reuse
    trainer.exe.run(trainer.main_program, feed=feeder.feed(batches[0]),
                    fetch_list=[cost], scope=trainer.scope)
    t0 = time.perf_counter()
    n = 0
    for b in batches:
        out = trainer.exe.run(trainer.main_program, feed=feeder.feed(b),
                              fetch_list=[cost], scope=trainer.scope)
        n += 1
    np.asarray(out[0])
    dt = (time.perf_counter() - t0) / n
    _out(json.dumps({"job": "time", "batches": n, "batch_size": bs,
                     "ms_per_batch": round(dt * 1e3, 3),
                     "samples_per_sec": round(bs / dt, 1)}))
    return 0


def _job_checkgrad(args):
    """Trainer::checkGradient: analytic parameter gradients against
    central finite differences (1e-3, float32) on one batch, at a few
    sampled elements a parameter."""
    import numpy as np

    from . import framework
    from . import reader as reader_mod
    from .backward import calc_gradient
    from .data_feeder import DataFeeder
    from .executor import Executor, Scope

    rec = _load_config(args)
    cost, = rec.outputs[:1]
    prog = rec.program
    params = [n for n, v in prog.global_block().vars.items()
              if isinstance(v, framework.Parameter) and v.trainable]
    grads = calc_gradient(cost, [prog.global_block().var(n)
                                 for n in params])
    params, grads = zip(*[(p, g) for p, g in zip(params, grads)
                          if g is not None])
    exe = Executor(_place(args))
    scope = Scope()
    exe.run(framework.default_startup_program(), scope=scope)

    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    train_sampler, _ = _provider_readers(rec, cfg_dir)
    if train_sampler is None:
        raise SystemExit("config has no train data source")
    bs = rec.batch_size or 32
    batch = next(reader_mod.batch(train_sampler, bs, drop_last=True)())
    feed_vars = [prog.global_block().var(n) for n in rec.feed_order]
    feed = DataFeeder(feed_vars).feed(batch)

    fetched = exe.run(prog, feed=feed, fetch_list=[cost] + list(grads),
                      scope=scope)
    base_cost = float(np.ravel(fetched[0])[0])
    _out(f"original cost = {base_cost:.6f}")
    rng = np.random.RandomState(0)
    eps, max_diff = 1e-3, 0.0
    for pname, g in zip(params, fetched[1:]):
        g = np.asarray(g, np.float64)
        val = np.array(scope.get(pname).detach().cpu().numpy(), np.float64)
        flat = val.reshape(-1)
        idxs = rng.choice(flat.size, size=min(4, flat.size), replace=False)
        for i in idxs:
            for sgn in (1, -1):
                pert = flat.copy()
                pert[i] += sgn * eps
                scope.set(pname, pert.reshape(val.shape).astype(np.float32))
                c, = exe.run(prog, feed=feed, fetch_list=[cost],
                             scope=scope)
                if sgn == 1:
                    hi = float(np.ravel(c)[0])
                else:
                    lo = float(np.ravel(c)[0])
            scope.set(pname, val.astype(np.float32))
            numeric = (hi - lo) / (2 * eps)
            analytic = float(g.reshape(-1)[i])
            denom = max(abs(numeric), abs(analytic), 1e-6)
            diff = abs(numeric - analytic) / denom
            max_diff = max(max_diff, diff)
            _out(f"  {pname}[{i}]: analytic={analytic:.6g} "
                 f"numeric={numeric:.6g} rel_diff={diff:.3g}")
    _out(f"max relative diff = {max_diff:.3g}")
    return 0 if max_diff < 5e-2 else 1


def _legacy_job(args):
    from . import flags, monitor
    for k, v in _parse_kv(args.set_flags).items():
        flags.set_flag(k, v)
    if args.metrics_path:
        flags.set_flag("metrics_path", args.metrics_path)
    if flags.get("metrics_path"):
        flags.set_flag("metrics", True)
    job = {"train": _job_train, "test": _job_test, "time": _job_time,
           "checkgrad": _job_checkgrad}[args.job]
    try:
        return job(args)
    finally:
        # written even when the job raises, and a dump failure never
        # masks the job's exception
        try:
            monitor.maybe_dump()
        except OSError as e:
            print(f"metrics dump failed: {e}", file=sys.stderr)


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.job in ("train", "test", "time", "checkgrad"):
        return _legacy_job(args)
    if args.job == "serve":
        return _serve(args)
    return _route(args)
