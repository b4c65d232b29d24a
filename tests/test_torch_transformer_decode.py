"""KV-cached generation inside a program (the `transformer_decode` and
`transformer_decode_step` ops, `models.transformer.transformer_lm_generate`)
in the port, on the CPU.

The twins of tests/test_transformer_decode.py (the cache path against a
step-by-step full forward, eos and `Lens`, sampling, train then
generate), and the port against the JAX package on the same weights:
greedy tokens exactly equal, the decode step's tokens and cache planes
at f32 tolerance. The JAX startup initialises both where they are
compared; the reference's decode runs plain XLA attention, the port's
K1's plain version.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu.ops import transformer_ops as JT
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.registry import get_op
from paddle_tpu_torch.weights import scope_from_numpy

V, H, L, NH, MAXLEN = 23, 16, 2, 2, 32


@pytest.fixture(autouse=True)
def fresh():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        P.executor._global_scope = P.Scope()
    yield


def _build_gen(P, max_new=6, eos_id=-1, temperature=0.0, Tp=5):
    prompt = P.layers.data("prompt", shape=[Tp], dtype="int64")
    plen = P.layers.data("plen", shape=[1], dtype="int64")
    ids, lens = P.models.transformer.transformer_lm_generate(
        prompt, plen, V, hid=H, num_layers=L, num_heads=NH,
        max_len=MAXLEN, max_new=max_new, eos_id=eos_id,
        temperature=temperature)
    return prompt, plen, ids, lens


def _port_gen(**kw):
    """The port's generation program, initialised by its own startup."""
    _, _, ids, lens = _build_gen(pt, **kw)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    return exe, pt.executor.global_scope(), ids, lens


def _prompts(seed, Tp, plens):
    prompts = np.random.RandomState(seed).randint(
        1, V, (len(plens), Tp)).astype(np.int64)
    plens = np.asarray(plens, np.int64)
    for b, n in enumerate(plens):
        prompts[b, n:] = 0                          # right padding
    return prompts, plens


def _oracle_greedy(exe, scope, prompts, plens, max_new):
    """Step-by-step greedy decode by a FULL forward recompute of the
    stacked transformer_lm over the same parameter names."""
    seqs = [list(p[:n]) for p, n in zip(prompts, plens)]
    out = [[] for _ in seqs]
    for _ in range(max_new):
        T = max(len(s) for s in seqs)
        pt.framework.reset_default_programs()
        tok = pt.layers.data("tok", shape=[T, 1], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, V, hid=H, num_layers=L, num_heads=NH, max_len=MAXLEN,
            stacked=True)
        batch = np.zeros((len(seqs), T, 1), np.int64)
        for b, s in enumerate(seqs):
            batch[b, :len(s), 0] = s
        lv, = exe.run(pt.default_main_program(), feed={"tok": batch},
                      fetch_list=[logits], scope=scope)
        for b, s in enumerate(seqs):
            nxt = int(np.argmax(lv[b, len(s) - 1]))
            s.append(nxt)
            out[b].append(nxt)
    return out


def test_generation_program_text_equals_the_jax_front_end():
    texts = []
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        _build_gen(P, max_new=4, eos_id=3, temperature=0.5)
        texts.append((P.default_main_program().to_dict(),
                      P.default_startup_program().to_dict()))
    assert texts[1] == texts[0]


def test_greedy_tokens_equal_the_jax_package():
    """Same weights (the JAX startup's), ragged prompts: the port's ids
    and lens are exactly the reference's."""
    Tp, max_new = 6, 7
    _, _, jids, jlens = _build_gen(jpt, max_new=max_new, Tp=Tp)
    jexe = jpt.Executor(jpt.CPUPlace())
    jscope = jpt.executor.global_scope()
    jexe.run(jpt.default_startup_program(), scope=jscope)
    _, _, pids, plens_v = _build_gen(pt, max_new=max_new, Tp=Tp)
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    prompts, plens = _prompts(0, Tp, [6, 1, 4, 3])
    feed = {"prompt": prompts, "plen": plens[:, None]}
    want = jexe.run(jpt.default_main_program(), feed=feed,
                    fetch_list=[jids, jlens], scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run(
        pt.default_main_program(), feed=feed, fetch_list=[pids, plens_v],
        scope=pscope)
    assert got[0].dtype == got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_greedy_decode_matches_full_forward():
    """Cache-incremental greedy ids == argmax of a full recompute at
    every step, including ragged prompt lengths."""
    Tp, max_new = 5, 6
    exe, scope, ids, lens = _port_gen(max_new=max_new, Tp=Tp)
    prompts, plens = _prompts(0, Tp, [5, 3, 4])
    got_ids, got_lens = exe.run(
        pt.default_main_program(),
        feed={"prompt": prompts, "plen": plens[:, None]},
        fetch_list=[ids, lens], scope=scope)
    want = _oracle_greedy(exe, scope, prompts, plens, max_new)
    np.testing.assert_array_equal(got_ids, np.asarray(want))
    np.testing.assert_array_equal(got_lens, [max_new] * 3)


def test_eos_stops_and_lens_count_the_eos():
    """Rows stop at eos_id; lens includes the eos token; later slots
    are eos-filled."""
    Tp, max_new = 4, 8
    exe, scope, ids, lens = _port_gen(max_new=max_new, Tp=Tp)
    prompts, plens = _prompts(1, Tp, [4, 4])
    feed = {"prompt": prompts, "plen": plens[:, None]}
    free_ids, _ = exe.run(pt.default_main_program(), feed=feed,
                          fetch_list=[ids, lens], scope=scope)
    # declare row 0's SECOND emitted token the eos and decode again
    eos = int(free_ids[0, 1])
    pt.framework.reset_default_programs()
    _, _, ids2, lens2 = _build_gen(pt, max_new=max_new, eos_id=eos, Tp=Tp)
    got_ids, got_lens = exe.run(pt.default_main_program(), feed=feed,
                                fetch_list=[ids2, lens2], scope=scope)
    assert got_ids[0, 1] == eos
    assert got_lens[0] == 2                       # the eos itself counts
    assert np.all(got_ids[0, 2:] == eos)          # eos-filled tail
    if eos not in free_ids[1]:
        assert got_lens[1] == max_new
        np.testing.assert_array_equal(got_ids[1], free_ids[1])


def test_sampled_decode_is_valid_and_seeded_by_the_port_generator():
    """temperature > 0: tokens in range; the draws come from the
    executor's generator, seeded from the program's seed, so a fresh
    scope with the same weights draws the same tokens, and the next run
    in one scope draws on from where the generator stands."""
    Tp, max_new = 4, 5
    exe, scope, ids, lens = _port_gen(max_new=max_new, temperature=1.0,
                                      Tp=Tp)
    prompts, plens = _prompts(2, Tp, [4, 2])
    feed = {"prompt": prompts, "plen": plens[:, None]}
    main = pt.default_main_program()

    def fresh_scope():      # the weights alone: a generator not yet drawn
        twin = pt.Scope()
        for n, t in scope.vars.items():
            if not n.startswith("__"):
                twin.set(n, t)
        return twin
    first = fresh_scope()
    a, alen = exe.run(main, feed=feed, fetch_list=[ids, lens], scope=first)
    assert np.all((a >= 0) & (a < V)) and list(alen) == [max_new] * 2
    b, _ = exe.run(main, feed=feed, fetch_list=[ids, lens],
                   scope=fresh_scope())
    np.testing.assert_array_equal(a, b)
    draws = [exe.run(main, feed=feed, fetch_list=[ids], scope=first)[0]
             for _ in range(3)]
    assert any(not np.array_equal(a, d) for d in draws)


def test_train_then_generate_shares_parameters():
    """The generation program decodes with the weights the stacked
    trainer just learned (same scope, same parameter names): training
    to predict a constant next token makes generation emit it."""
    Tp, max_new, target, B, T = 4, 4, 7, 8, 8
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tok", shape=[T, 1], dtype="int64")
        nxt = pt.layers.data("nxt", shape=[T, 1], dtype="int64")
        cost = pt.models.transformer.transformer_lm_cost(
            tok, nxt, V, hid=H, num_layers=L, num_heads=NH,
            max_len=MAXLEN, stacked=True)
        pt.AdamOptimizer(5e-3).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    for _ in range(60):
        exe.run(main, feed={"tok": rng.randint(1, V, (B, T, 1)),
                            "nxt": np.full((B, T, 1), target, np.int64)},
                fetch_list=[cost], scope=scope)
    gen, gen_startup = pt.Program(), pt.Program()
    with pt.program_guard(gen, gen_startup):
        _, _, ids, _ = _build_gen(pt, max_new=max_new, Tp=Tp)
    got, = exe.run(gen, feed={"prompt": rng.randint(1, V, (2, Tp)),
                              "plen": np.full((2, 1), Tp, np.int64)},
                   fetch_list=[ids], scope=scope)
    assert np.all(got == target), got


def test_pos_table_shorter_than_prompt_plus_max_new_raises():
    exe, scope, ids, _ = _port_gen(max_new=MAXLEN, Tp=5)
    prompts, plens = _prompts(4, 5, [5])
    with pytest.raises(ValueError, match="pos table 32 is shorter"):
        exe.run(pt.default_main_program(),
                feed={"prompt": prompts, "plen": plens[:, None]},
                fetch_list=[ids], scope=scope)


def test_generate_adopts_the_trained_pos_emb_length():
    scope = pt.executor.global_scope()
    scope.set("pos_emb", torch.zeros(48, H))
    with pytest.warns(UserWarning, match="using 48"):
        _build_gen(pt, max_new=2)
    pos = pt.default_main_program().global_block().var("pos_emb")
    assert tuple(pos.shape) == (48, H)


# -- transformer_decode_step ------------------------------------------------

S, TCAP = 3, 12


def _decode_step_program(out_suffix):
    """A program of one transformer_decode_step op over fed caches; its
    CacheKOut / CacheVOut vars are the inputs' names + out_suffix."""
    from paddle_tpu_torch.models.transformer import _stack_param_specs
    from paddle_tpu_torch.ops.transformer_ops import _LEAVES
    main = pt.Program()
    blk = main.global_block()
    D = H // NH
    feeds = {"tok": ([S], "int64"), "pos_idx": ([S], "int64"),
             "live": ([S], "bool"), "ck": ([L, S, NH, TCAP, D], "float32"),
             "cv": ([L, S, NH, TCAP, D], "float32"),
             "emb": ([V, H], "float32"), "pos": ([MAXLEN, H], "float32"),
             "lnfg": ([H], "float32"), "lnfb": ([H], "float32"),
             "headw": ([H, V], "float32")}
    feeds.update({f"stack.{n}": (shape, "float32") for n, (shape, _)
                  in _stack_param_specs(H, L).items()})
    for name, (shape, dtype) in feeds.items():
        blk.create_var(name=name, shape=shape, dtype=dtype, is_data=True)
    ins = {"Tok": ["tok"], "PosIdx": ["pos_idx"], "Live": ["live"],
           "CacheK": ["ck"], "CacheV": ["cv"], "Emb": ["emb"],
           "Pos": ["pos"], "LnFG": ["lnfg"], "LnFB": ["lnfb"],
           "HeadW": ["headw"]}
    ins.update({n: [f"stack.{n}"] for n in _LEAVES})
    outs = {"Next": ["next"], "CacheKOut": ["ck" + out_suffix],
            "CacheVOut": ["cv" + out_suffix]}
    for name, dtype in (("next", "int64"), ("ck" + out_suffix, "float32"),
                        ("cv" + out_suffix, "float32")):
        blk.create_var(name=name, dtype=dtype)
    blk.append_op("transformer_decode_step", ins, outs, {"num_heads": NH})
    return main, feeds


def _decode_step_feed(feeds, seed=8):
    rng = np.random.RandomState(seed)
    feed = {}
    for name, (shape, dtype) in feeds.items():
        if dtype == "float32":
            scale = 1.0 if name in ("ck", "cv", "lnfg") else 0.3
            feed[name] = (rng.randn(*shape) * scale).astype(np.float32)
    feed.update(tok=np.array([4, 9, 13]), pos_idx=np.array([0, 3, 11]),
                live=np.array([False, True, True]))
    return feed


@pytest.mark.parametrize("out_suffix", ["_out", ""])
def test_decode_step_matches_the_reference(out_suffix):
    """Next and the written cache planes against the reference lowering
    (tokens equal, planes at 1e-5); the input planes do not change when
    the output vars are other vars, and are written in place when they
    are the same vars."""
    main, feeds = _decode_step_program(out_suffix)
    feed = _decode_step_feed(feeds)
    ck_in = torch.from_numpy(feed["ck"].copy())
    cv_in = torch.from_numpy(feed["cv"].copy())
    run_feed = dict(feed, ck=ck_in, cv=cv_in)
    nxt, ck, cv = pt.Executor(pt.CPUPlace()).run(
        main, feed=run_feed,
        fetch_list=["next", "ck" + out_suffix, "cv" + out_suffix],
        return_numpy=False)
    jins = {"Tok": [feed["tok"]], "PosIdx": [feed["pos_idx"]],
            "Live": [feed["live"]], "CacheK": [feed["ck"]],
            "CacheV": [feed["cv"]], "Emb": [feed["emb"]],
            "Pos": [feed["pos"]], "LnFG": [feed["lnfg"]],
            "LnFB": [feed["lnfb"]], "HeadW": [feed["headw"]]}
    jins.update({n: [feed[f"stack.{n}"]] for n in JT._LEAVES})
    import jax.numpy as jnp
    ref = JT._transformer_decode_step(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in jins.items()},
        {"num_heads": NH})
    assert nxt.dtype == torch.int64
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref["Next"][0]))
    assert int(nxt[0]) == 0                       # dead slot forced to 0
    for got, want in ((ck, ref["CacheKOut"][0]), (cv, ref["CacheVOut"][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    if out_suffix:
        assert torch.equal(ck_in, torch.from_numpy(feed["ck"]))
        assert torch.equal(cv_in, torch.from_numpy(feed["cv"]))
        assert not torch.equal(ck, ck_in)
    else:
        assert torch.equal(ck_in, ck) and torch.equal(cv_in, cv)


def test_generation_ops_are_registered_and_infer_on_meta_tensors():
    for op in ("transformer_stack", "quant_transformer_stack",
               "transformer_decode", "transformer_decode_step"):
        assert get_op(op).type == op
    _, _, ids, lens = _build_gen(pt, max_new=6, Tp=5)
    assert ids.shape == (-1, 6) and lens.shape == (-1,)
    main, _ = _decode_step_program("_out")
    blk = main.global_block()
    assert blk.var("next").shape == (S,)
    assert blk.var("ck_out").shape == blk.var("ck").shape
