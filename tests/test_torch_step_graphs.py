"""The serving rungs as CUDA graphs (paddle_tpu_torch/serving/graphs.py).

On the CPU: every LM rung function and the one-shot engine's
`Executor.run` of a tiny int8 program run on meta tensors, where a
value-dependent host read (`torch.nonzero`, `.item()`) raises just as
it would break a CUDA-graph capture; the slab prefill writes exactly
its real rows' slots; the executor takes a device tensor feed of the
var's dtype as it is and casts numpy feeds as before; both engines send
every dispatch through their graph runner by rung key.

On the card (marker `cuda`, skipped here): each rung's graph against
the eager function on the same inputs, bitwise, outputs and KV planes;
co-batched == solo with graphs on, and == the eager engine; the launch
counters carried through replays; each one-shot bucket's reply ==
`Executor.run`'s, bitwise. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_step_graphs.py
"""

import gc
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor, quant
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import quant_ops as qo
from paddle_tpu_torch.ops import transformer_ops as PT
from paddle_tpu_torch.serving import (EngineConfig, GenerationConfig,
                                      GenerationEngine, InferenceEngine,
                                      LMSpec, init_lm_weights)
from paddle_tpu_torch.ops.launch_counts import counters
from paddle_tpu_torch.serving.graphs import StepGraphs
from paddle_tpu_torch.weights import lm_weights_from_numpy

SPEC = LMSpec(vocab_size=31, hidden_size=16, num_layers=2, num_heads=2,
              max_len=32)
WEIGHTS = init_lm_weights(SPEC, seed=3)
L, N = SPEC.num_layers, SPEC.num_heads
D = SPEC.hidden_size // N
CFG = dict(max_slots=3, prefill_batch=2, max_prompt_len=8,
           max_new_tokens=6, default_deadline_ms=60000,
           prompt_buckets=[4, 8], batch_buckets=[1, 2])
PROMPTS = [np.array([3, 7, 11, 2, 5]), np.array([1, 4]),
           np.array([9, 9, 2, 8, 8, 1, 0]), np.array([6])]
# the one-shot engine's tiny GPT-2 (tests/test_torch_inference_serving.py)
V1, H1, L1, N1, T1 = 96, 64, 2, 2, 16


def _head(device):
    w = lm_weights_from_numpy(WEIGHTS, SPEC, "cpu")
    w = {k: v.to(device) for k, v in w.items()}
    return (tuple(w[f"stack.{leaf}"] for leaf in PT._LEAVES), w["tok_emb"],
            w["pos_emb"], w["ln_f.w_0"], w["ln_f.w_1"], w["lm_head.w"], N)


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _planes(*shape):
    return (_meta(*shape, dtype=torch.float32),
            _meta(*shape, dtype=torch.float32))


# ---------------------------------------------------------------------------
# the LM rung functions on meta tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t", [(2, 8), (1, 4)])
def test_slot_prefill_runs_on_meta(b, t):
    ck, cv = _planes(L, 3, N, 14, D)
    tok0 = PT.slot_prefill(*_head("meta"), ck, cv, _meta(b, t), _meta(b),
                           _meta(b))
    assert tok0.shape == (b,) and tok0.dtype == torch.int32


@pytest.mark.parametrize("b,t", [(2, 8), (1, 4)])
def test_paged_prefill_runs_on_meta_and_gathers_per_layer(b, t):
    ck, cv = _planes(L, 9, N, 4, D)
    before = fa.gather_pages.calls
    tok0 = PT.paged_prefill(*_head("meta"), ck, cv, _meta(b, t), _meta(b),
                            _meta(b), _meta(b, 4))
    assert tok0.shape == (b,) and tok0.dtype == torch.int32
    assert fa.gather_pages.calls - before == 2 * L


def test_slot_decode_step_runs_on_meta():
    ck, cv = _planes(L, 3, N, 14, D)
    nxt = PT.slot_decode_step(*_head("meta"), ck, cv, _meta(3), _meta(3),
                              _meta(3, dtype=torch.bool))
    assert nxt.shape == (3,) and nxt.dtype == torch.int32


def test_paged_decode_step_runs_on_meta_and_gathers_nothing():
    ck, cv = _planes(L, 9, N, 4, D)
    before = fa.gather_pages.calls
    nxt = PT.paged_decode_step(*_head("meta"), ck, cv, _meta(3), _meta(3),
                               _meta(3, dtype=torch.bool), _meta(3, 4))
    assert nxt.shape == (3,) and nxt.dtype == torch.int32
    assert fa.gather_pages.calls == before


def test_page_copy_runs_on_meta_as_the_rung_calls_it():
    ck, cv = _planes(L, 9, N, 4, D)
    # the engine's page_copy rung: int64 [1] page ids on the device
    assert PT.page_copy(ck, cv, _meta(1, dtype=torch.long),
                        _meta(1, dtype=torch.long)) is None
    assert ck.shape == (L, 9, N, 4, D)


def test_slot_prefill_writes_only_its_real_rows_slots():
    """Pad rows (slot ids >= S, two of them on one id) write nothing;
    real rows overwrite cache rows 0..t-1 of their own slot and nothing
    else; every other value keeps its bits."""
    S, Tcap, t = 4, 10, 6
    rng = np.random.RandomState(1)
    ck0, cv0 = (torch.from_numpy(rng.randn(L, S, N, Tcap, D)
                                 .astype(np.float32)) for _ in range(2))
    ck, cv = ck0.clone(), cv0.clone()
    toks = torch.from_numpy(rng.randint(0, 31, (4, t)).astype(np.int32))
    plen = torch.tensor([6, 3, 2, 1], dtype=torch.int32)
    slots = torch.tensor([2, S, 0, S], dtype=torch.int32)
    PT.slot_prefill(*_head("cpu"), ck, cv, toks, plen, slots)
    for c, c0 in ((ck, ck0), (cv, cv0)):
        assert torch.equal(c[:, [1, 3]], c0[:, [1, 3]])
        assert torch.equal(c[:, :, :, t:], c0[:, :, :, t:])
        assert not torch.equal(c[:, 2, :, :t], c0[:, 2, :, :t])
        assert not torch.equal(c[:, 0, :, :t], c0[:, 0, :, :t])
    # each real row's K/V is its own: the same row prefilled alone
    ck1, cv1 = ck0.clone(), cv0.clone()
    PT.slot_prefill(*_head("cpu"), ck1, cv1, toks[:1], plen[:1], slots[:1])
    np.testing.assert_allclose(ck[:, 2].numpy(), ck1[:, 2].numpy(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the one-shot path: Executor.run on meta tensors, device-tensor feeds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_dir(tmp_path_factory):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [T1], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, V1, hid=H1, num_layers=L1, num_heads=N1, max_len=T1)
        ids = pt.layers.argmax(logits, axis=-1)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    root = tmp_path_factory.mktemp("graphs")
    src, out = str(root / "f32"), str(root / "int8")
    pt.io.save_inference_model(src, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    quant.quantize_inference_model(src, out, executor=exe)
    return out, logits.name


def test_int8_executor_run_on_meta_tensors(int8_dir):
    out, logits_name = int8_dir
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(out, exe, scope=scope)
    assert {op.type for op in prog.global_block().ops} >= {
        "quant_mul", "quant_lookup_table", "scaled_dot_product_attention"}
    for name in list(scope.keys()):
        if isinstance(scope.get(name), torch.Tensor):
            scope.set(name, scope.get(name).to("meta"))
    exe.device = torch.device("meta")
    ids, logits = exe.run(prog, feed={"tokens": _meta(4, T1,
                                                      dtype=torch.int64)},
                          fetch_list=[fetch[0], logits_name], scope=scope,
                          return_numpy=False)
    assert ids.shape == (4, T1) and ids.dtype == torch.int64
    assert logits.shape == (4, T1, V1) and logits.device.type == "meta"


def _feed_program():
    pt.framework.reset_default_programs()
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        pt.layers.data("tokens", [T1], dtype="int64")
    return main


def test_coerce_feed_passes_a_device_tensor_of_the_var_dtype_through():
    main = _feed_program()
    exe = pt.Executor(pt.CPUPlace())
    t = torch.arange(2 * T1, dtype=torch.int64).reshape(2, T1)
    assert exe._coerce_feed(main, "tokens", t) is t
    meta = pt.Executor(pt.CPUPlace())
    meta.device = torch.device("meta")
    m = _meta(2, T1, dtype=torch.int64)
    assert meta._coerce_feed(main, "tokens", m) is m
    # another dtype is cast on the host, as a numpy feed
    got = exe._coerce_feed(main, "tokens", t.to(torch.int32))
    assert got.dtype == torch.int64 and torch.equal(got, t)


def test_coerce_feed_casts_numpy_exactly_as_before():
    main = _feed_program()
    exe = pt.Executor(pt.CPUPlace())
    for arr in (np.arange(2 * T1, dtype=np.int32).reshape(2, T1),
                np.full((1, T1), 7.9, np.float32),
                [[1] * T1]):
        want = pt.executor.host_cast_feed(main, "tokens", np.asarray(arr))
        got = exe._coerce_feed(main, "tokens", arr)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the engines send every dispatch through their runner, by rung key
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for StepGraphs on the CPU: runs the rung's function
    eagerly on CPU tensors and records each dispatch's key and input
    shapes."""

    def __init__(self, device=None):
        self.calls = []

    def keys(self):
        return list(dict.fromkeys(k for k, _ in self.calls))

    def __len__(self):
        return len(self.keys())

    def run(self, key, fn, *host):
        self.calls.append((key, tuple(np.shape(a) for a in host)))
        out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in host])
        outs = (() if out is None else out
                if isinstance(out, (tuple, list)) else (out,))
        return [o.numpy() for o in outs]


@pytest.mark.parametrize("paged", [True, False])
def test_lm_engine_dispatches_every_rung_by_key(paged):
    cfg = GenerationConfig(paged=paged, page_len=4, **CFG)
    with GenerationEngine(SPEC, WEIGHTS, config=cfg, device="cpu") as eager:
        want = [eager.generate(p, timeout=120)[0].tolist() for p in PROMPTS]
    eng = GenerationEngine(SPEC, WEIGHTS, config=cfg, device="cpu",
                           start=False)
    eng._graphs = _Recorder()
    assert eng.warmup() == cfg.rung_keys()
    assert eng._graphs.keys() == cfg.rung_keys()        # largest first
    eng.start()
    try:
        got = [eng.generate(p, timeout=120)[0].tolist() for p in PROMPTS]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == want
    assert st["aot_status"] == "cuda_graph"
    assert st["aot_rungs"] == cfg.rung_keys()
    S, m = cfg.max_slots, cfg.pages_per_seq
    for key, shapes in eng._graphs.calls:
        if key == "decode":
            assert shapes == ((S,), (S,), (S,)) + (((S, m),) if paged
                                                   else ())
        elif key == "page_copy":
            assert shapes == ((1,), (1,))
        else:
            b, t = (int(x) for x in key.split(":")[1].split("x"))
            assert shapes[0] == (b, t) and {s[0] for s in shapes} == {b}


def test_one_shot_engine_dispatches_every_bucket_by_key(int8_dir):
    out, logits_name = int8_dir
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(out, exe, scope=scope)
    fetch_names = [fetch[0].name, logits_name]

    def infer_fn(*tensors):             # as from_program's on the card
        return exe.run(prog, feed=dict(zip(feeds, tensors)),
                       fetch_list=fetch_names, scope=scope,
                       return_numpy=False)

    monitor.reset()
    monitor.set_enabled(True)
    engine = InferenceEngine(
        infer_fn, feeds, fetch_names,
        input_specs=[{"name": "tokens", "dtype": "int64",
                      "shape": [-1, T1]}],
        config=EngineConfig(max_batch_size=4, batch_timeout_ms=0),
        start=False)
    engine._graphs = _Recorder()        # as from_program's on the card
    engine.start()
    try:
        assert engine.warmup() == [1, 2, 4]
        x = np.random.RandomState(2).randint(0, V1, (3, T1)).astype(np.int64)
        got = engine.infer({"tokens": x}, timeout=60)
        st = engine.stats()
        gauge = monitor.snapshot()["gauges"]["serving.compiled_shapes"]
    finally:
        engine.shutdown()
        monitor.reset()
        monitor.set_enabled(False)
    want = exe.run(prog, feed={"tokens": x}, fetch_list=fetch_names,
                   scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [k for k, _ in engine._graphs.calls] == [
        (((b, T1), "<i8"),) for b in (4, 2, 1, 4)]
    assert st["aot_buckets"] == [1, 2, 4] and st["aot_status"] == "cuda_graph"
    assert gauge == 3


def test_counters_cover_every_wrapper_count():
    names = {(getattr(w, "__name__", ""), a) for w, a in counters()}
    assert ("gather_pages", "calls") in names
    assert ("flash_attn_fwd", "decode_launches") in names
    for w in (fa.flash_attn_fwd, fa.flash_attn_fwd_bf16,
              qo.int8_matmul_rescaled, qo.quantize_activations):
        assert (w.__name__, "launches") in names
    assert ("int8_matmul_rescaled", "repacks") in names


def test_a_tally_holds_only_its_own_threads_counts():
    """A capture takes back the counts its thread made while it ran;
    a count that another thread made meanwhile (another engine's
    replay) stays."""
    import threading
    w = fa.flash_attn_fwd
    before = w.launches
    with launch_counts.tallied() as tally:
        launch_counts.count(w, "launches", 3)
        other = threading.Thread(
            target=lambda: launch_counts.count(w, "launches", 5))
        other.start()
        other.join()
        with launch_counts.tallied() as inner:
            launch_counts.count(w, "launches")
    assert inner == {(w, "launches"): 1}
    assert tally == {(w, "launches"): 4}
    assert w.launches == before + 9
    w.launches = before


@pytest.mark.parametrize("S", [1, 3])
def test_slot_targets_give_each_row_its_own_slot(S):
    """Every list of b <= S ids: the rows that write are those whose
    id is in [0, S) and first on it, each on its own slot; every other
    row goes to a distinct slot that no row writes."""
    import itertools
    for b in range(1, S + 1):
        for ids in itertools.product(range(-1, S + 2), repeat=b):
            tgt, writes = PT._slot_targets(
                torch.tensor(ids, dtype=torch.int32), S)
            tgt, writes = tgt.tolist(), writes.tolist()
            seen = []
            for i, s in enumerate(ids):
                want = 0 <= s < S and s not in seen
                seen += [s] if want else []
                assert writes[i] == want, ids
                assert not want or tgt[i] == s, ids
            assert len(set(tgt)) == b, ids
            assert not {t for t, w in zip(tgt, writes) if not w} & set(seen)
    with pytest.raises(ValueError):
        PT._slot_targets(torch.zeros(S + 1, dtype=torch.int32), S)


def test_cpu_engines_stay_eager():
    with GenerationEngine(SPEC, WEIGHTS, config=GenerationConfig(**CFG),
                          device="cpu") as eng:
        assert eng._graphs is None
        assert eng.stats()["aot_rungs"] == []
    one_shot = InferenceEngine(lambda x: [x], ["x"], ["y"], start=False)
    assert one_shot._graphs is None
    assert one_shot.stats()["aot_status"] == "none"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels they "
                    "replay run only there")
    return torch.device("cuda")


CARD_SPEC = LMSpec(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
                   max_len=64)
CARD_WEIGHTS = init_lm_weights(CARD_SPEC, seed=5)
CARD_CFG = dict(max_slots=4, prefill_batch=2, max_prompt_len=16,
                max_new_tokens=8, default_deadline_ms=60000,
                prompt_buckets=[8, 16], batch_buckets=[1, 2], page_len=4,
                prefix_cache=False)


def _card_engine(paged, start=False):
    return GenerationEngine(CARD_SPEC, CARD_WEIGHTS,
                            config=GenerationConfig(paged=paged, **CARD_CFG),
                            start=start, device="cuda")


def _rung_inputs(eng, key, rng):
    """Host inputs of one dispatch of `key` that write real state: live
    rows on their own slots / pages, positions inside their tables."""
    cfg = eng.config
    S, m, P = cfg.max_slots, cfg.pages_per_seq, cfg.num_pages
    pages = rng.permutation(np.arange(1, P + 1))
    if key == "page_copy":
        return (np.array([pages[0]], np.int64),
                np.array([pages[1]], np.int64))
    if key == "decode":
        tok = rng.randint(0, 64, S).astype(np.int32)
        live = np.array([True, False, True, True][:S])
        pos = rng.randint(0, cfg.max_cache_len, S).astype(np.int32)
        if not cfg.paged:
            return tok, pos, live
        tables = np.zeros((S, m), np.int32)
        for i in np.flatnonzero(live):
            tables[i] = pages[i * m:(i + 1) * m]
        return tok, pos, live, tables
    b, t = (int(x) for x in key.split(":")[1].split("x"))
    toks = rng.randint(0, 64, (b, t)).astype(np.int32)
    plen = rng.randint(1, t + 1, b).astype(np.int32)
    if not cfg.paged:
        slots = rng.permutation(S)[:b].astype(np.int32)
        slots[-1] = S if b > 1 else slots[-1]            # a pad row
        return toks, plen, slots
    tables = np.stack([pages[i * m:(i + 1) * m] for i in range(b)]
                      ).astype(np.int32)
    return toks, np.zeros(b, np.int32), plen, tables


def _eager_fn(eng, key):
    return {"decode": eng._decode_fn,
            "page_copy": eng._copy_fn}.get(key, eng._prefill_fn)


def _graph_dispatch(eng, key, host):
    if key == "decode":
        return eng._dispatch_decode(*host)
    if key == "page_copy":
        return eng._dispatch_copy(int(host[0][0]), int(host[1][0]))
    return eng._dispatch_prefill(*host)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_each_rung_graph_equals_the_eager_step_bitwise(card, paged):
    """For every rung key, twice (the capture, then a plain replay on
    other inputs): outputs and the KV planes after the step equal the
    eager function's on the same inputs and state, bit for bit. The
    paged trash page (page 0, written by pad rows and dead slots in any
    order) is left out."""
    eng = _card_engine(paged)
    rng = np.random.RandomState(0)
    skip = 1 if paged else 0
    with torch.inference_mode():
        for key in eng.config.rung_keys():
            for _ in range(2):
                for c in (eng._ck, eng._cv):
                    c.copy_(torch.randn(c.shape, device=card))
                state = eng._ck.clone(), eng._cv.clone()
                host = _rung_inputs(eng, key, rng)
                want = _eager_fn(eng, key)(*eng._to_device(*host))
                want = None if want is None else want.cpu().numpy()
                after = eng._ck.clone(), eng._cv.clone()
                eng._ck.copy_(state[0])
                eng._cv.copy_(state[1])
                got = _graph_dispatch(eng, key, host)
                if want is not None:
                    assert np.array_equal(got, want), key
                for c, a in zip((eng._ck, eng._cv), after):
                    assert torch.equal(c[:, skip:], a[:, skip:]), key
    assert eng.stats()["aot_rungs"] == eng.config.rung_keys()
    assert eng.stats()["aot_status"] == "cuda_graph"


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_cobatched_equals_solo_and_eager_with_graphs(card, paged):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 64, n) for n in (13, 3, 8, 16, 1)]
    with _card_engine(paged, start=True) as eng:
        eng.warmup()
        solo = [eng.generate(p, timeout=120)[0].tolist() for p in prompts]
        streams = [eng.submit(p) for p in prompts]
        together = [s.result(timeout=120)[0].tolist() for s in streams]
        st = eng.stats()
    eager = _card_engine(paged, start=True)
    eager._graphs = None                      # the eager steps, on the card
    with eager:
        want = [eager.generate(p, timeout=120)[0].tolist() for p in prompts]
    assert together == solo == want
    assert st["admitted_mid_flight"] > 0
    assert st["aot_rungs"] == eng.config.rung_keys()


def _zero_counts():
    for w, a in counters():
        setattr(w, a, 0)


@pytest.mark.cuda
def test_a_capture_runs_with_the_collector_off(card):
    """A dropped engine is a reference cycle holding CUDA graphs; the
    collector, run mid-capture, would destroy them inside the capture
    and invalidate it. The warm-up call runs with the collector on, the
    captured call with it off, and it is on again afterwards."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1

    graphs = StepGraphs(card)
    out, = graphs.run("k", fn, np.arange(4, dtype=np.float32))
    assert seen == [True, False] and gc.isenabled()
    np.testing.assert_array_equal(out, np.arange(1, 5, dtype=np.float32))
    out, = graphs.run("k", fn, np.full(4, 7, np.float32))   # a replay
    assert len(seen) == 2
    np.testing.assert_array_equal(out, np.full(4, 8, np.float32))


@pytest.mark.cuda
def test_replays_carry_the_launch_counters(card):
    eng = _card_engine(True)
    eng.warmup()
    rng = np.random.RandomState(2)
    reps = 5
    _zero_counts()
    with torch.inference_mode():
        for _ in range(reps):
            eng._dispatch_decode(*_rung_inputs(eng, "decode", rng))
    assert fa.flash_attn_fwd.launches == reps * L
    assert fa.gather_pages.calls == 0
    _zero_counts()
    with torch.inference_mode():
        for _ in range(reps):
            eng._dispatch_prefill(*_rung_inputs(eng, "prefill:2x16", rng))
    assert fa.flash_attn_fwd.launches == reps * L
    assert fa.gather_pages.calls == reps * 2 * L


@pytest.fixture
def card_int8(card, tmp_path):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [T1], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, V1, hid=H1, num_layers=L1, num_heads=N1, max_len=T1)
        ids = pt.layers.argmax(logits, axis=-1)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    src, out = os.path.join(tmp_path, "f32"), os.path.join(tmp_path, "int8")
    pt.io.save_inference_model(src, ["tokens"], [ids], exe,
                               main_program=main, scope=scope)
    quant.quantize_inference_model(src, out, executor=exe)
    qscope = pt.Scope()
    prog, feeds, fetch = pt.io.load_inference_model(out, exe, scope=qscope)
    return exe, qscope, prog, feeds, [fetch[0].name, logits.name]


@pytest.mark.cuda
def test_one_shot_bucket_graphs_equal_executor_run_bitwise(card_int8):
    exe, scope, prog, feeds, fetch = card_int8
    engine = InferenceEngine.from_program(
        prog, feeds, fetch, executor=exe, scope=scope,
        config=EngineConfig(max_batch_size=4, buckets=(1, 2, 4),
                            batch_timeout_ms=0))
    try:
        assert engine.warmup() == [1, 2, 4]
        rng = np.random.RandomState(3)
        per = {}
        for b in (4, 2, 1):
            x = rng.randint(0, V1, (b, T1)).astype(np.int64)
            _zero_counts()
            got = engine.infer({"tokens": x}, timeout=60)
            per[b] = (qo.int8_matmul_rescaled.launches,
                      qo.quantize_activations.launches,
                      fa.flash_attn_fwd.launches)
            want = exe.run(prog, feed={"tokens": x}, fetch_list=fetch,
                           scope=scope)
            for g, w in zip(got, want):
                assert np.array_equal(g, w), b
        st = engine.stats()
    finally:
        engine.shutdown()
    # one replay a dispatch: 4 int8 products a block and the lm head
    assert set(per.values()) == {(4 * L1 + 1, 4 * L1 + 1, L1)}
    assert st["aot_buckets"] == [1, 2, 4]
    assert st["aot_status"] == "cuda_graph"
