"""Command line of the port.

    python -m paddle_tpu_torch serve --generate --artifact lm.pdmodel \
        [--port 8080] [--host 127.0.0.1] [--device cpu]

serves an LM artifact written by the JAX package
(`paddle_tpu.io.export_lm_artifact`) through the continuous-batching
engine behind `POST /v1/generate`. The HTTP server binds before warmup
(`/healthz` answers "booting" until every rung has run once); SIGTERM
drains the in-flight generations and exits 0.
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
    p.add_argument("--generate", action="store_true",
                   help="serve a generative-LM artifact through "
                        "POST /v1/generate (required: one-shot "
                        "inference serving is not ported yet)")
    p.add_argument("--artifact", required=True,
                   help="an LM artifact (paddle_tpu.io.export_lm_artifact)")
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
    return p


def _serve(args):
    from . import flags
    from .io import read_lm_artifact
    from .serving.http import make_server
    from .serving.lm import GenerationConfig, GenerationEngine, LMSpec

    if not args.generate:
        raise SystemExit("only `serve --generate` (LM artifacts) is "
                         "ported; one-shot inference serving is not")
    # GET /metrics is part of the serve contract: recording is on
    flags.set_flag("metrics", True)
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
    server = make_server(engine, host=args.host, port=args.port,
                         read_timeout_s=args.read_timeout_s)
    port = server.server_address[1]
    http_thread = threading.Thread(target=server.serve_forever,
                                   name="paddle-tpu-torch-http",
                                   daemon=True)
    http_thread.start()
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
    st = engine.stats()
    _log(f"served {st['completed']} generations / {st['tokens']} tokens "
         f"in {st['decode_steps']} decode steps (shed={st['shed']}, "
         f"rejected={st['rejected']})")
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.job == "serve":
        return _serve(args)
    return 2
