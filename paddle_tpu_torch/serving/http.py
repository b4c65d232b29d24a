"""Stdlib-only HTTP front end over a GenerationEngine.

The port of the LM half of `paddle_tpu/serving/http.py`:

  POST /v1/generate  {"prompt": [token ids], "max_new_tokens": 32,
                      "deadline_ms": 5000, "stream": true}
                   Streaming (the default) replies 200 + chunked NDJSON,
                   one JSON object per line as the decode loop emits:
                   {"event": "token", "token": id} per token, then
                   {"event": "done", "finish_reason": ..., "num_tokens":
                   n}. The status line is held until the first event
                   resolves, so failures before any token are typed HTTP
                   errors (400/429/503/504); failures after streaming
                   began become an in-band {"event": "error",
                   "error_type": ...} line. "stream": false collects the
                   whole generation into one {"tokens": [...],
                   "finish_reason": ...} reply.
  POST /v1/infer   404 with a routing hint: this replica serves an LM.
  GET  /healthz    engine stats(): 200 "ready" once warmup() completed,
                   503 "booting" before, 503 "shutdown" after close;
                   `?live` answers 200 "alive" through boot and drain.
  GET  /metrics    Prometheus text of the monitor registry
                   (?format=json for the raw snapshot dict).

Every reply carries the request's trace id in `x-trace-id`: an inbound
`x-trace-id` header (bounded, header-safe) is adopted, otherwise one is
minted. Each accepted connection gets a socket read timeout
(`read_timeout_s`, default the `serving_read_timeout_s` flag) so a
client that stalls mid-request cannot pin a handler thread.
"""

from __future__ import annotations

import itertools
import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from .. import flags, monitor
from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError)

__all__ = ["make_server", "ServingHandler", "resolve_trace_id"]

_MAX_BODY = 64 << 20
_TRACE_ID_OK = re.compile(r"[0-9A-Za-z_.-]+")


class QuietHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that does not print tracebacks for routine
    client disconnects and read timeouts."""

    daemon_threads = True

    def handle_error(self, request, client_address):
        import sys
        if isinstance(sys.exc_info()[1], (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def resolve_trace_id(raw):
    """Adopt a valid inbound `x-trace-id` (<= 64 header-safe chars) or
    mint a fresh one."""
    raw = (raw or "").strip()
    if raw and len(raw) <= 64 and _TRACE_ID_OK.fullmatch(raw):
        return raw
    return monitor.new_trace_id()


class ServingHandler(BaseHTTPRequestHandler):
    # the engine is attached to the *server* by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet: metrics cover traffic
        pass

    def setup(self):
        super().setup()
        read_timeout = getattr(self.server, "read_timeout_s", None)
        if read_timeout:
            self.connection.settimeout(read_timeout)

    def _read_body(self):
        length = int(self.headers.get("Content-Length", 0))
        if not 0 < length <= _MAX_BODY:
            self.close_connection = True
            raise ValueError(f"Content-Length {length} outside "
                             f"(0, {_MAX_BODY}]")
        return self.rfile.read(length)

    def _reply(self, code, payload, content_type="application/json",
               trace_id=None):
        if trace_id and isinstance(payload, dict):
            payload = {**payload, "trace_id": trace_id}
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if trace_id:
            self.send_header("x-trace-id", trace_id)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):   # noqa: N802 (stdlib handler naming)
        engine = self.server.engine
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            stats = engine.stats()
            if "live" in parse_qs(query, keep_blank_values=True):
                self._reply(200, {"status": "alive", **stats})
            elif stats["closed"]:
                self._reply(503, {"status": "shutdown", **stats})
            elif not stats["ready"]:
                self._reply(503, {"status": "booting", **stats})
            else:
                self._reply(200, {"status": "ready", **stats})
        elif path == "/metrics":
            snap = monitor.snapshot()
            if "format=json" in query:
                self._reply(200, snap)
            else:
                self._reply(200, monitor.format_prometheus(snap).encode(),
                            content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": f"no route {path!r}"})

    def _stream_chunk(self, obj):
        """One NDJSON line as one HTTP/1.1 chunk (wfile is unbuffered,
        so each token hits the wire as the decode loop emits it)."""
        data = json.dumps(obj).encode() + b"\n"
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    def do_POST(self):   # noqa: N802
        path = self.path.partition("?")[0]
        if path != "/v1/generate":
            # replying without consuming the body would leave it to be
            # parsed as the next request on this keep-alive connection
            self.close_connection = True
            hint = (": this replica serves a generative LM — POST "
                    "/v1/generate" if path == "/v1/infer" else "")
            self._reply(404, {"error": f"no route {path!r} here{hint}"})
            return
        self._generate(self.server.engine)

    def _generate(self, engine):
        trace_id = resolve_trace_id(self.headers.get("x-trace-id"))
        try:
            try:
                raw = self._read_body()
            except TimeoutError:
                self.close_connection = True
                self._reply(408, {"error": "timed out reading the "
                                           "request body",
                                  "error_type": "timeout"},
                            trace_id=trace_id)
                return
            req = json.loads(raw)
            prompt = req["prompt"]
            if not isinstance(prompt, list):
                raise ValueError('"prompt" must be a list of token ids')
            # dtype is NOT coerced: floats/ragged nesting must fail the
            # engine's integer-1D validation as a 400
            ids = np.asarray(prompt)
            max_new = req.get("max_new_tokens")
            if max_new is not None:
                max_new = int(max_new)
            deadline_ms = req.get("deadline_ms")
            deadline = (float(deadline_ms) / 1e3
                        if deadline_ms is not None else None)
            streaming = bool(req.get("stream", True))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request: {e}"},
                        trace_id=trace_id)
            return
        try:
            gen = engine.submit(ids, max_new_tokens=max_new,
                                deadline=deadline, trace_id=trace_id)
        except ValueError as e:               # prompt validation
            self._reply(400, {"error": str(e)}, trace_id=trace_id)
            return
        except ServerOverloadedError as e:
            self._reply(429, {"error": str(e), "error_type": "shed"},
                        trace_id=trace_id)
            return
        except EngineClosedError as e:
            self._reply(503, {"error": str(e), "error_type": "unavailable"},
                        trace_id=trace_id)
            return
        if not streaming:
            try:
                out, reason = gen.result()
            except Exception as e:            # noqa: BLE001 typed below
                self._reply_error(e, trace_id)
            else:
                self._reply(200, {"tokens": [int(t) for t in out],
                                  "finish_reason": reason},
                            trace_id=trace_id)
            return
        # streaming: block for the FIRST event before committing a
        # status line, so a request that fails before any token still
        # gets its typed HTTP error
        events = gen.events()
        try:
            first = next(events)
        except Exception as e:                # noqa: BLE001 typed below
            self._reply_error(e, trace_id)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("x-trace-id", trace_id)
        self.end_headers()
        try:
            try:
                for kind, payload in itertools.chain([first], events):
                    if kind == "token":
                        self._stream_chunk({"event": "token",
                                            "token": int(payload)})
                    else:
                        self._stream_chunk({"event": "done", **payload,
                                            "trace_id": trace_id})
            except (ConnectionError, TimeoutError, OSError):
                raise                          # client-side, not engine
            except Exception as e:             # noqa: BLE001 in-band
                self._stream_chunk({"event": "error", "error": str(e),
                                    "error_type": _error_type(e),
                                    "trace_id": trace_id})
            self.wfile.write(b"0\r\n\r\n")     # terminal chunk
        except (ConnectionError, TimeoutError, OSError):
            # the client went away mid-stream: cancel the generation so
            # the engine frees its slot at the next decode step
            engine.cancel(gen)
            self.close_connection = True

    def _reply_error(self, e, trace_id):
        code = {"deadline": 504, "unavailable": 503}.get(_error_type(e), 500)
        payload = {"error": str(e) if code != 500
                   else f"generation failed: {e}"}
        if code != 500:
            payload["error_type"] = _error_type(e)
        self._reply(code, payload, trace_id=trace_id)


def _error_type(e):
    if isinstance(e, DeadlineExceededError):
        return "deadline"
    if isinstance(e, EngineClosedError):
        return "unavailable"
    return "internal"


def make_server(engine, host="127.0.0.1", port=8080, read_timeout_s=None):
    """ThreadingHTTPServer with `engine` attached. port=0 binds an
    ephemeral port (read it back from `server.server_address[1]`). The
    caller owns the lifecycle: serve_forever() (often in a thread), then
    server.shutdown(); engine.shutdown(drain=True)."""
    if read_timeout_s is None:
        read_timeout_s = flags.get("serving_read_timeout_s")
    server = QuietHTTPServer((host, port), ServingHandler)
    server.engine = engine
    server.read_timeout_s = float(read_timeout_s) or None
    return server
