"""`InferenceEngine.from_artifact` in the port, against the JAX package.

The JAX package writes version-3 artifacts that embed their program
(`io.export_inference_artifact(..., embed_program=True)`): a tiny MLP
and a tiny `transformer_lm` + argmax (2 layers, narrow). The port's
`from_artifact` serves them on the CPU from the embedded program and its
npz arrays; the JAX package's `InferenceEngine.from_artifact(aot=False)`
serves the StableHLO module of the same file. Outputs agree within 1e-5
on the same seeded rows, ids exactly; a quantized artifact's within 1e-5
of its largest output (test_torch_quant.py's band for the default
int8_matmul mode), argmax equal. Also: a fixed-batch export gives one
rung, a quantized artifact's `meta["quant"]` shows in `stats()`, and
a plain artifact, a truncated file and a file with trailing garbage each
raise the named ValueError.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401  (jpt.models)
from paddle_tpu import quant as jquant
from paddle_tpu import serving as jserving
from paddle_tpu_torch import io as io_mod
from paddle_tpu_torch.serving import EngineConfig, InferenceEngine

ATOL = 1e-5
# int8 against int8, both packages at int8_matmul "auto": of the largest
# |output| (test_torch_quant.py's band for that mode)
INT8_AUTO_BAND = 1e-5
F, HIDDEN, CLASSES = 12, 32, 5
V, H, L, HEADS, T = 64, 32, 2, 2, 8
LM_B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's intra-op work in one thread while this file runs: the
    tier-1 run puts several pytest workers on the same cores
    (tests/torch_port_helpers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _export(path, build, fetch_of, batch_size=None, embed=True,
            quantize=False):
    """Build a program with the JAX package, run its startup and export
    it. Returns the artifact path."""
    jpt.framework.reset_default_programs()
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        feeds, outs = build()
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    exe.run(startup, scope=scope)
    fetch = fetch_of(outs)
    quant_meta = None
    if quantize:
        pruned = jpt.io._prune_for_inference(main, feeds,
                                             [v.name for v in fetch])
        main, scope, quant_meta = jquant.quantize_program(
            pruned, scope, min_elements=0)
        fetch = [v.name for v in fetch]
    jpt.io.export_inference_artifact(
        path, feeds, fetch, exe, main_program=main, scope=scope,
        batch_size=batch_size, embed_program=embed,
        quant_meta=quant_meta)
    return path


def _mlp():
    x = jpt.layers.data("x", [F], dtype="float32")
    h = jpt.layers.fc(x, HIDDEN, act="relu")
    return ["x"], [jpt.layers.fc(h, CLASSES, act="softmax")]


def _lm():
    tok = jpt.layers.data("tokens", [T], dtype="int64")
    logits = jpt.models.transformer.transformer_lm(
        tok, V, hid=H, num_layers=L, num_heads=HEADS, max_len=T)
    return ["tokens"], [logits, jpt.layers.argmax(logits, axis=-1)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    return {
        "mlp": _export(str(root / "mlp.pdmodel"), _mlp, list),
        # the JAX transformer lowering cannot export a symbolic batch
        "lm": _export(str(root / "lm.pdmodel"), _lm, list,
                      batch_size=LM_B),
        "fixed": _export(str(root / "fixed.pdmodel"), _mlp, list,
                         batch_size=4),
        "int8": _export(str(root / "int8.pdmodel"), _mlp, list,
                        quantize=True),
        "plain": _export(str(root / "plain.pdmodel"), _mlp, list,
                         embed=False),
    }


def _rows(kind, seed, n):
    rng = np.random.RandomState(seed)
    if kind == "lm":
        return {"tokens": rng.randint(0, V, (n, T)).astype(np.int64)}
    return {"x": rng.randn(n, F).astype(np.float32)}


def _serve_both(path, requests, config=None):
    """Each request through the port's engine (CPU) and the JAX
    package's (StableHLO, jit, no AOT rungs)."""
    cfg = dict(max_batch_size=8, batch_timeout_ms=0.0)
    with InferenceEngine.from_artifact(
            path, config=config or EngineConfig(**cfg),
            device="cpu") as port, \
            jserving.InferenceEngine.from_artifact(
                path, config=jserving.EngineConfig(**cfg),
                aot=False) as ref:
        port.warmup()
        got = [port.infer(r, timeout=120) for r in requests]
        want = [ref.infer(r, timeout=120) for r in requests]
        return got, want, port.stats()


@pytest.mark.parametrize("kind", ["mlp", "lm", "int8"])
def test_from_artifact_matches_the_jax_engine(artifacts, kind):
    """int8: the embedded program and arrays (int8 weights, their
    per-channel scales) against the file's StableHLO module."""
    # a fixed-batch export admits its baked batch only
    sizes = (LM_B,) * 3 if kind == "lm" else (1, 3, 8, 5)
    rows = "lm" if kind == "lm" else "mlp"
    requests = [_rows(rows, seed, n) for seed, n in enumerate(sizes)]
    got, want, stats = _serve_both(artifacts[kind], requests)
    assert stats["aot_status"] == "none"      # the CPU: eager rungs
    assert stats["warmed_buckets"] == ([LM_B] if kind == "lm"
                                       else [1, 2, 4, 8])
    for g, w in zip(got, want):
        assert len(g) == len(w)
        ref = np.asarray(w[0])
        if kind == "int8":
            assert g[0].shape == ref.shape
            assert (np.abs(g[0] - ref).max()
                    <= INT8_AUTO_BAND * np.abs(ref).max())
            np.testing.assert_array_equal(g[0].argmax(-1), ref.argmax(-1))
        else:
            np.testing.assert_allclose(g[0], ref, rtol=0, atol=ATOL)
        if kind == "lm":
            # the argmax ids: equal, not close
            np.testing.assert_array_equal(g[1], np.asarray(w[1]))


def test_fixed_batch_artifact_serves_one_rung(artifacts):
    path = artifacts["fixed"]
    meta = io_mod.read_artifact_meta(path)
    assert meta["symbolic_batch"] is False
    requests = [_rows("mlp", 7, 4), _rows("mlp", 8, 4)]
    got, want, stats = _serve_both(
        path, requests, config=EngineConfig(max_batch_size=16,
                                            batch_timeout_ms=0.0))
    assert stats["buckets"] == [4] and stats["warmed_buckets"] == [4]
    assert stats["max_batch_size"] == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=0,
                                   atol=ATOL)
    # another batch size is refused by both engines alike
    with InferenceEngine.from_artifact(path, device="cpu") as port, \
            jserving.InferenceEngine.from_artifact(path, aot=False) as ref:
        for eng in (port, ref):
            with pytest.raises(ValueError, match="does not match"):
                eng.submit(_rows("mlp", 9, 2))


def test_quantized_artifact_reports_its_quant_meta(artifacts):
    path = artifacts["int8"]
    meta = io_mod.read_artifact_meta(path)
    assert meta["quant"]["quantized_ops"] == 2
    with InferenceEngine.from_artifact(path, device="cpu") as eng:
        st = eng.stats()["quant"]
        assert st["source"] == "artifact"
        for key in ("scheme", "kernel", "quantized_ops",
                    "quantized_weights", "bytes_saved"):
            assert st[key] == meta["quant"][key], key
        out = eng.infer(_rows("mlp", 4, 3), timeout=120)[0]
    assert out.shape == (3, CLASSES) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)


def test_embedded_program_round_trips(artifacts):
    meta, program, arrays = io_mod.read_embedded_program(artifacts["mlp"])
    assert meta["feed_names"] == ["x"]
    assert {op.type for op in program.global_block().ops} >= {"mul",
                                                              "softmax"}
    persist = {n for n, v in program.global_block().vars.items()
               if v.persistable}
    assert persist and persist <= set(arrays)


def test_plain_artifact_raises_the_named_error(artifacts):
    with pytest.raises(ValueError, match="embed_program=True"):
        InferenceEngine.from_artifact(artifacts["plain"], device="cpu")
    with pytest.raises(ValueError, match="embed_program=True"):
        io_mod.read_embedded_program(artifacts["plain"])


@pytest.mark.parametrize("damage", ["truncated", "trailing"])
def test_damaged_artifact_raises_the_named_error(artifacts, tmp_path,
                                                 damage):
    data = open(artifacts["mlp"], "rb").read()
    bad = tmp_path / "bad.pdmodel"
    bad.write_bytes(data[:-7] if damage == "truncated"
                    else data + b"garbage")
    with pytest.raises(ValueError, match="truncated write or trailing "
                                         "garbage"):
        io_mod.read_artifact_meta(str(bad))
    with pytest.raises(ValueError, match="not a loadable paddle_tpu "
                                         "inference artifact"):
        InferenceEngine.from_artifact(str(bad), device="cpu")
