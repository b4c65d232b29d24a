"""The port's one-shot serving path on the CPU: a quantized model dir
behind `InferenceEngine.from_program`, its HTTP front end and the
`serve --model_dir` CLI, and the quality gate of the int8 model (the
twin of tools/check_quantize.py's B and C, at its scale).

Port only: the JAX package is not imported here (test_torch_quant.py
holds the port to it).
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, quant
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineClosedError, EngineConfig,
                                      InferenceEngine, ServerOverloadedError)
from paddle_tpu_torch.serving.batching import pad_to_bucket, split_rows
from paddle_tpu_torch.serving.http import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, L, N_HEADS, T = 96, 64, 2, 2, 16


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    flags.reset()


def _lm_program(vocab, hid, layers, heads, T_):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [T_], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, vocab, hid=hid, num_layers=layers, num_heads=heads,
            max_len=T_)
        ids = pt.layers.argmax(logits, axis=-1)
    return main, startup, logits, ids


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """An f32 model dir saved by the port (fetch: the argmax ids) and its
    int8 twin from the port's quantize_inference_model."""
    root = tmp_path_factory.mktemp("serve")
    main, startup, logits, ids = _lm_program(V, H, L, N_HEADS, T)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    src, out = str(root / "f32"), str(root / "int8")
    pt.io.save_inference_model(src, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    _, report = quant.quantize_inference_model(src, out, executor=exe)
    return src, out, logits.name, report


def _load(dirname):
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(dirname, exe,
                                                    scope=scope)
    return prog, feeds, fetch, exe, scope


def _tokens(rows, seed):
    return np.random.RandomState(seed).randint(0, V, (rows, T)).astype(
        np.int64)


# ---------------------------------------------------------------------------
# batching helpers
# ---------------------------------------------------------------------------

def test_pad_to_bucket_and_split_rows():
    a = [np.arange(6).reshape(2, 3), np.ones((2, 1), np.float32)]
    b = [np.arange(3).reshape(1, 3) + 10, np.zeros((1, 1), np.float32)]
    padded, slices = pad_to_bucket([a, b], 4)
    assert [p.shape for p in padded] == [(4, 3), (4, 1)]
    assert slices == [slice(0, 2), slice(2, 3)]
    assert not padded[0][3].any() and padded[0].dtype == a[0].dtype
    per = split_rows(padded, slices)
    np.testing.assert_array_equal(per[0][0], a[0])
    np.testing.assert_array_equal(per[1][0], b[0])
    with pytest.raises(ValueError, match="do not fit"):
        pad_to_bucket([a, b], 2)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_model_dir_report_and_program(model_dirs):
    _, out, _, report = model_dirs
    # 4 muls a block, the lm head, tok_emb's lookup
    assert report["quantized_ops"] == 4 * L + 2
    assert report["kernel"] == "int8.sym.perchannel/1"
    assert report["baked_platform"] == ("cuda" if torch.cuda.is_available()
                                        else "cpu")
    assert quant.stats()["quantized_ops"] == 4 * L + 2
    prog, feeds, fetch, _, scope = _load(out)
    assert quant.has_quant_ops(prog)
    assert feeds == ["tokens"] and fetch[0].dtype == "int64"
    assert scope.get("block0.qkv.w").dtype == torch.int8


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_engine_cobatched_equals_solo_and_executor(model_dirs, mode):
    """Requests of 1-3 rows co-batch into one dispatch padded to a rung;
    every reply (ids and logits) is bitwise the solo reply and the
    Executor's run of the same rows."""
    _, out, logits_name, _ = model_dirs
    flags.set_flag("int8_matmul", mode)
    prog, feeds, fetch, exe, scope = _load(out)
    reqs = [_tokens(r, 20 + i) for i, r in enumerate((1, 3, 2, 1))]
    engine = InferenceEngine.from_program(
        prog, feeds, [fetch[0], logits_name], executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=8, batch_timeout_ms=500))
    try:
        assert engine.warmup() == [1, 2, 4, 8]
        solo = [engine.infer({"tokens": x}, timeout=60) for x in reqs]
        before = engine.stats()["batches"]
        pending = [engine.submit({"tokens": x}) for x in reqs]
        together = [p.result(timeout=60) for p in pending]
        st = engine.stats()
    finally:
        engine.shutdown()
    assert st["batches"] - before == 1            # one co-batched dispatch
    assert st["completed"] == 2 * len(reqs) and st["errors"] == 0
    assert st["distinct_dispatch_shapes"] == 4
    for x, a, b in zip(reqs, solo, together):
        ids, logits = exe.run(prog, feed={"tokens": x},
                              fetch_list=[fetch[0], logits_name],
                              scope=scope)
        for got in (a, b):
            np.testing.assert_array_equal(got[0], ids)
            np.testing.assert_array_equal(got[1], logits)


class _Gate:
    """An infer_fn that blocks until released: holds the batcher."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        self.entered.set()
        self.release.wait(30)
        return [x * 2]


def _gated_engine(**cfg):
    gate = _Gate()
    engine = InferenceEngine(
        gate, ["x"], ["y"],
        input_specs=[{"name": "x", "dtype": "float32", "shape": [-1, 2]}],
        config=EngineConfig(**{"max_batch_size": 4, "batch_timeout_ms": 0,
                               **cfg}))
    return engine, gate


def test_engine_sheds_expired_requests_before_dispatch():
    engine, gate = _gated_engine()
    try:
        first = engine.submit({"x": np.ones((1, 2))})
        assert gate.entered.wait(10)
        late = engine.submit({"x": np.ones((1, 2))}, deadline=0.05)
        time.sleep(0.1)
        gate.release.set()
        assert first.result(10)[0].tolist() == [[2.0, 2.0]]
        with pytest.raises(DeadlineExceededError):
            late.result(10)
        # an exhausted budget is shed on arrival, never dispatched
        with pytest.raises(DeadlineExceededError):
            engine.infer({"x": np.ones((1, 2))}, deadline=0, timeout=10)
        st = engine.stats()
    finally:
        gate.release.set()
        engine.shutdown()
    assert st["shed"] == 2 and gate.calls == 1


def test_engine_rejects_on_a_full_queue_and_validates_feeds():
    engine, gate = _gated_engine(queue_limit=1)
    try:
        first = engine.submit({"x": np.ones((1, 2))})
        assert gate.entered.wait(10)
        queued = engine.submit({"x": np.ones((2, 2))})
        with pytest.raises(ServerOverloadedError):
            engine.submit({"x": np.ones((1, 2))})
        for bad, what in (({"y": np.ones((1, 2))}, "exactly"),
                          ({"x": np.ones((1, 3))}, "spec"),
                          ({"x": np.ones((5, 2))}, "max_batch_size")):
            with pytest.raises(ValueError, match=what):
                engine.submit(bad)
        gate.release.set()
        first.result(10)
        assert queued.result(10)[0].shape == (2, 2)
        st = engine.stats()
    finally:
        gate.release.set()
        engine.shutdown()
    assert st["rejected"] == 1 and st["completed"] == 2


@pytest.mark.parametrize("drain", [True, False])
def test_engine_shutdown_drains_or_fails_the_queue(drain):
    engine, gate = _gated_engine(max_batch_size=1)
    first = engine.submit({"x": np.ones((1, 2))})
    assert gate.entered.wait(10)
    queued = [engine.submit({"x": np.full((1, 2), i)}) for i in range(3)]
    closer = threading.Thread(target=engine.shutdown,
                              kwargs={"drain": drain})
    closer.start()
    time.sleep(0.05)
    gate.release.set()
    closer.join(30)
    assert not closer.is_alive()
    assert first.result(10)[0].tolist() == [[2.0, 2.0]]
    for i, p in enumerate(queued):
        if drain:
            assert p.result(10)[0].tolist() == [[2.0 * i] * 2]
        else:
            with pytest.raises(EngineClosedError):
                p.result(10)
    with pytest.raises(EngineClosedError):
        engine.submit({"x": np.ones((1, 2))})
    st = engine.stats()
    assert st["closed"] and st["completed"] == (4 if drain else 1)
    assert st["abandoned"] == (0 if drain else 3)


def test_default_device_raises_without_a_card(model_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default resolves to it")
    src, out, _, _ = model_dirs
    prog, feeds, fetch, _, scope = _load(out)
    with pytest.raises(RuntimeError, match="CUDA card"):
        InferenceEngine.from_program(prog, feeds, fetch, scope=scope,
                                     start=False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        quant.quantize_inference_model(src, out + ".again")


# ---------------------------------------------------------------------------
# HTTP and the CLI
# ---------------------------------------------------------------------------

def _request(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    payload = body if isinstance(body, (bytes, str)) else json.dumps(body)
    conn.request("POST", path, payload,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data


def _serve(engine):
    server = make_server(engine, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_infer_round_trip_and_errors(model_dirs):
    _, out, _, _ = model_dirs
    prog, feeds, fetch, exe, scope = _load(out)
    engine = InferenceEngine.from_program(
        prog, feeds, fetch, executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=4, batch_timeout_ms=1))
    server, port = _serve(engine)
    try:
        x = _tokens(3, 7)
        code, hdrs, body = _request(port, "/v1/infer",
                                    {"feeds": {"tokens": x.tolist()}},
                                    {"x-trace-id": "cafe0123deadbeef"})
        assert code == 200 and hdrs["x-trace-id"] == "cafe0123deadbeef"
        reply = json.loads(body)
        assert reply["fetch_names"] == [fetch[0].name]
        ids, = exe.run(prog, feed={"tokens": x}, fetch_list=fetch,
                       scope=scope)
        assert reply["outputs"][0] == ids.tolist()
        for bad in (b"not json", {"feed": {}}, {"feeds": [1, 2]},
                    {"feeds": {"tok": x.tolist()}},
                    {"feeds": {"tokens": [[1, 2]]}},
                    {"feeds": {"tokens": x.tolist()}, "deadline_ms": "x"}):
            code, _, body = _request(port, "/v1/infer", bad)
            assert code == 400, (bad, body)
        code, _, body = _request(port, "/v1/generate", {"prompt": [1]})
        assert code == 404 and b"POST /v1/infer" in body
        code, _, _ = _request(port, "/v2/whatever", {})
        assert code == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["status"] == "ready" and health["completed"] == 1
    finally:
        server.shutdown()
        engine.shutdown()


def test_http_infer_429_and_504_are_typed():
    engine, gate = _gated_engine(queue_limit=1)
    server, port = _serve(engine)
    try:
        first = engine.submit({"x": np.ones((1, 2))})
        assert gate.entered.wait(10)
        results = {}
        waiter = threading.Thread(target=lambda: results.setdefault(
            "late", _request(port, "/v1/infer", {
                "feeds": {"x": [[1.0, 2.0]]}, "deadline_ms": 50})))
        waiter.start()
        deadline = time.monotonic() + 10
        while engine.stats()["queue_depth"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, _, body = _request(port, "/v1/infer",
                                 {"feeds": {"x": [[1.0, 2.0]]}})
        assert code == 429 and json.loads(body)["error_type"] == "shed"
        time.sleep(0.1)
        gate.release.set()
        waiter.join(30)
        first.result(10)
        code, _, body = results["late"]
        assert code == 504 and json.loads(body)["error_type"] == "deadline"
    finally:
        gate.release.set()
        server.shutdown()
        engine.shutdown()


def test_cli_serves_a_quantized_model_dir_on_cpu(model_dirs):
    _, out, _, _ = model_dirs
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model_dir",
         out, "--port", "0", "--device", "cpu", "--max_batch_size", "4",
         "--buckets", "1,4", "--batch_timeout_ms", "1"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "serve never reported its port"
        x = _tokens(2, 9)
        code, _, body = _request(port, "/v1/infer",
                                 {"feeds": {"tokens": x.tolist()}})
        assert code == 200
        prog, _, fetch, exe, scope = _load(out)
        ids, = exe.run(prog, feed={"tokens": x}, fetch_list=fetch,
                       scope=scope)
        assert json.loads(body)["outputs"][0] == ids.tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "served 1 requests in 1 batches" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


# ---------------------------------------------------------------------------
# the quality gate (tools/check_quantize.py B and C, at its scale)
# ---------------------------------------------------------------------------

# tools/check_quantize.py's model (:76) and bands (:63-:67)
QV, QH, QL, QHEADS, QT, QB = 2048, 768, 1, 12, 32, 8
TOP1_AUTO, REL_AUTO = 0.99, 0.02
TOP1_INT8, REL_INT8 = 0.98, 0.05


@pytest.fixture(scope="module")
def trained_dirs(tmp_path_factory):
    """The tool's GPT-2-small block trained 60 Adam steps at lr 2e-3 on
    its fixed corpus (memorised: real top-1 margins), saved f32 with
    its logits fetched, and quantized."""
    rng = np.random.RandomState(0)
    corpus = rng.randint(1, QV, (4, QB, QT)).astype(np.int64)
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tokens = pt.layers.data("tokens", [QT], dtype="int64")
        labels = pt.layers.data("labels", [QT, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tokens, labels, QV, hid=QH, num_layers=QL, num_heads=QHEADS,
            max_len=QT)
        pt.AdamOptimizer(2e-3).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for step in range(60):
        toks = corpus[step % len(corpus)]
        nxt = np.roll(toks, -1, axis=1)
        nxt[:, -1] = 0
        losses.append(float(exe.run(
            main, feed={"tokens": toks, "labels": nxt[..., None]},
            fetch_list=[cost], scope=scope)[0][0]))
    infmain, _, logits, _ = _lm_program(QV, QH, QL, QHEADS, QT)
    root = tmp_path_factory.mktemp("quality")
    src, out = str(root / "f32"), str(root / "int8")
    pt.io.save_inference_model(src, ["tokens"], [logits], exe,
                               main_program=infmain, scope=scope)
    quant.quantize_inference_model(src, out, executor=exe)
    held = [np.random.RandomState(100 + i).randint(1, QV, (QB, QT))
            .astype(np.int64) for i in range(4)]
    return src, out, held + list(corpus), losses


@pytest.mark.parametrize("mode,top1_min,rel_max",
                         [("auto", TOP1_AUTO, REL_AUTO),
                          ("pallas", TOP1_INT8, REL_INT8)])
def test_int8_model_holds_check_quantize_bands(trained_dirs, mode,
                                               top1_min, rel_max):
    src, out, eval_sets, losses = trained_dirs
    assert losses[-1] < losses[0] - 1.0, losses
    flags.set_flag("int8_matmul", mode)
    fprog, _, ffetch, fexe, fscope = _load(src)
    qprog, _, qfetch, qexe, qscope = _load(out)
    agree = total = 0
    rel = 0.0
    for toks in eval_sets:
        a, = fexe.run(fprog, feed={"tokens": toks}, fetch_list=ffetch,
                      scope=fscope)
        b, = qexe.run(qprog, feed={"tokens": toks}, fetch_list=qfetch,
                      scope=qscope)
        rel = max(rel, float(np.abs(a - b).max() / np.abs(a).max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        total += a.shape[0] * a.shape[1]
    top1 = agree / total
    assert top1 >= top1_min and rel <= rel_max, (mode, top1, rel)
