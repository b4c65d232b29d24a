"""Command line of the port.

    python -m paddle_tpu_torch serve --model_dir DIR \
        [--max_batch_size 16] [--batch_timeout_ms 2] [--buckets 1,2,4,8]
    python -m paddle_tpu_torch serve --generate --artifact lm.pdmodel
        [--port 8080] [--host 127.0.0.1] [--device cpu]

Telemetry: `--set flag=value,...` sets any flag (as the env spelling
PADDLE_TPU_<FLAG> would), e.g. `--set metrics_sample_s=1,trace_path=
/tmp/t.json,blackbox_dir=/tmp/bb,profile_sample_n=16`; `--metrics_path
FILE` dumps the registry there at exit (`monitor.maybe_dump()`, also
when serving fails). `GET /debug/vars` serves the introspection payload.

`--model_dir` serves a `save_inference_model` directory (f32, or int8
from `quant.quantize_inference_model`; either package's) through the
micro-batching engine behind `POST /v1/infer`. `--artifact` serves an
LM artifact written by the JAX package (`paddle_tpu.io.
export_lm_artifact`) through the continuous-batching engine behind
`POST /v1/generate`. Both run on the card unless `--device cpu`. The
HTTP server binds before warmup (`/healthz` answers "booting" until
every rung has run once); SIGTERM drains the in-flight requests and
exits 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

__all__ = ["main"]


def _log(msg):
    print(f"[paddle_tpu_torch] {msg}", file=sys.stderr, flush=True)


def _parser():
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    p.add_argument("job", choices=["serve"])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model_dir",
                     help="a save_inference_model directory (json): "
                          "one-shot serving, POST /v1/infer")
    src.add_argument("--artifact",
                     help="an LM artifact (paddle_tpu.io."
                          "export_lm_artifact): POST /v1/generate")
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

    if args.generate and args.model_dir:
        raise SystemExit("--generate needs an LM artifact (--artifact); "
                         f"{args.model_dir} is a one-shot inference model "
                         "(it serves without --generate)")
    for k, v in _parse_kv(args.set_flags).items():
        flags.set_flag(k, v)
    if args.metrics_path:
        flags.set_flag("metrics_path", args.metrics_path)
    # GET /metrics is part of the serve contract: recording is on
    flags.set_flag("metrics", True)
    # resolve the telemetry flags now: trace_path starts the ambient
    # trace and metrics_sample_s the sampler (their side effects)
    flags.get("trace_path")
    flags.get("metrics_sample_s")
    from . import monitor
    try:
        if args.model_dir:
            return _serve_model_dir(args)
        return _serve_lm(args)
    finally:
        # written even when serving raises; a dump failure never masks
        # the job's own exception
        try:
            monitor.maybe_dump()
        except OSError as e:
            _log(f"metrics dump failed: {e}")


def _run_until_sigterm(server, engine):
    """Serve until SIGTERM / Ctrl-C, then stop accepting and drain."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    except KeyboardInterrupt:
        pass
    _log("draining...")
    server.shutdown()
    engine.shutdown(drain=True)
    return engine.stats()


def _start_http(engine, args):
    from .serving.http import make_server
    server = make_server(engine, host=args.host, port=args.port,
                         read_timeout_s=args.read_timeout_s)
    threading.Thread(target=server.serve_forever,
                     name="paddle-tpu-torch-http", daemon=True).start()
    return server, server.server_address[1]


def _serve_model_dir(args):
    from . import io as io_mod
    from .executor import Executor, Scope
    from .serving.engine import EngineConfig, InferenceEngine

    if not os.path.isdir(args.model_dir):
        raise SystemExit(f"--model_dir not found: {args.model_dir}")
    buckets = ([int(b) for b in args.buckets.split(",") if b]
               if args.buckets else None)
    cfg = EngineConfig(max_batch_size=args.max_batch_size,
                       batch_timeout_ms=args.batch_timeout_ms,
                       queue_limit=args.queue_limit, buckets=buckets)
    exe = Executor(args.device)
    scope = Scope()
    program, feed_names, fetch_vars = io_mod.load_inference_model(
        args.model_dir, exe, scope=scope)
    engine = InferenceEngine.from_program(
        program, feed_names, fetch_vars, executor=exe, scope=scope,
        config=cfg)
    engine.set_ready(False)
    server, port = _start_http(engine, args)
    if args.no_warmup:
        engine.set_ready(True)
    else:
        _log(f"warmed buckets {engine.warmup()}")
    _log(f"serving {args.model_dir} on http://{args.host}:{port} "
         f"(device={exe.device}, max_batch={cfg.max_batch_size}, "
         f"timeout={cfg.batch_timeout_ms}ms, "
         f"queue_limit={cfg.queue_limit}, buckets={list(cfg.buckets)}) "
         "— POST /v1/infer")
    st = _run_until_sigterm(server, engine)
    _log(f"served {st['completed']} requests in {st['batches']} batches "
         f"(shed={st['shed']}, rejected={st['rejected']}, "
         f"errors={st['errors']})")
    return 0


def _serve_lm(args):
    from .io import read_lm_artifact
    from .serving.lm import GenerationConfig, GenerationEngine, LMSpec

    if not os.path.exists(args.artifact):
        raise SystemExit(f"--artifact file not found: {args.artifact}")
    meta, weights = read_lm_artifact(args.artifact)
    spec = LMSpec.from_meta(meta["lm"]["model"])
    config = GenerationConfig.from_meta(
        meta["lm"]["serving"],
        **({"queue_limit": args.queue_limit}
           if args.queue_limit is not None else {}))
    engine = GenerationEngine(spec, weights, config=config, ready=False,
                              device=args.device)
    server, port = _start_http(engine, args)
    if args.no_warmup:
        engine.set_ready(True)
    else:
        _log(f"warmed rungs {engine.warmup()}")
    _log(f"serving LM {args.artifact} on http://{args.host}:{port} "
         f"(device={engine.device}, slots={config.max_slots}, "
         f"prefill_batch={config.prefill_batch}, "
         f"max_prompt={config.max_prompt_len}, "
         f"max_new={config.max_new_tokens}, paged={config.paged}) "
         "— POST /v1/generate")
    st = _run_until_sigterm(server, engine)
    _log(f"served {st['completed']} generations / {st['tokens']} tokens "
         f"in {st['decode_steps']} decode steps (shed={st['shed']}, "
         f"rejected={st['rejected']})")
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.job == "serve":
        return _serve(args)
    return 2
