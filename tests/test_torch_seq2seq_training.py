"""Training steps of the sequence models in both packages from the same
weights (the JAX startup's, through `weights.scope_from_numpy`), on the
CPU: seq2seq-attention and the stacked-LSTM sentiment net in f32, then
seq2seq and the conv sentiment net under bf16 amp, and the FLOP tally
behind `perf.mfu` on the seq2seq step.

Tolerances:
  * f32, three Adam steps on a ragged batch (a zero-length row
    included): every step's loss within 1e-5 relative, and every
    parameter after the steps within 1e-4 of its largest element (the
    two packages sum the recurrences' products in other orders);
  * amp: every var of a step has the JAX package's dtype (the int32
    `@SEQLEN` feeds never cast; matmul and sequence_conv compute in
    bf16; gru / lstm / cos_sim / sequence_softmax in f32); three steps'
    losses within 2e-3 relative, as the GPT-2 amp test
    (tests/test_torch_amp.py): bf16 keeps 8 significand bits and the
    packages round in other places.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
from paddle_tpu import amp as jamp
from paddle_tpu.monitor import introspect as jintrospect
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.monitor import introspect
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 3


def _seq2seq(P, V=20, E=12, H=12):
    src, tgt, nxt = [P.layers.data(n, [1], dtype="int64", lod_level=1)
                     for n in ("src", "tgt", "nxt")]
    cost = P.models.seq2seq.seq2seq_attention_cost(src, tgt, nxt, V, V,
                                                   emb_dim=E, hid_dim=H)
    P.AdamOptimizer(1e-2).minimize(cost)
    return cost


def _seq2seq_feed(B=5, T=7, V=20, seed=3):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, (B,)).astype(np.int64)   # bench.py's int64
    lens[0], lens[-1] = T, 0
    feed = {}
    for i, n in enumerate(("src", "tgt", "nxt")):
        toks = rng.randint(1, V, (B, T, 1)).astype(np.int64)
        toks[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[n], feed[n + "@SEQLEN"] = toks, lens
    return feed


def _lstm_net(P):
    words = P.layers.data("words", [1], dtype="int64", lod_level=1)
    label = P.layers.data("label", [1], dtype="int64")
    probs = P.models.lstm_text.stacked_lstm_net(words, vocab_size=30,
                                                emb_dim=8, hid_dim=8)
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    P.AdamOptimizer(1e-2).minimize(cost)
    return cost


def _conv_net(P):
    words = P.layers.data("words", [1], dtype="int64", lod_level=1)
    label = P.layers.data("label", [1], dtype="int64")
    probs = P.models.lstm_text.conv_net(words, vocab_size=30, emb_dim=8,
                                        hid_dim=8)
    cost = P.layers.mean(P.layers.cross_entropy(probs, label))
    P.AdamOptimizer(1e-2).minimize(cost)
    return cost


def _words_feed(B=6, T=9, seed=4):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, (B,)).astype(np.int32)
    lens[-1] = 0
    toks = rng.randint(1, 30, (B, T, 1)).astype(np.int64)
    toks[np.arange(T)[None, :] >= lens[:, None]] = 0
    return {"words": toks, "words@SEQLEN": lens,
            "label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def _both(build, use_amp=False):
    """The program built in both packages (equal Program dicts), the
    JAX startup run, and the port's scope made from its weights."""
    progs = {}
    for P, A in ((jpt, jamp), (pt, amp)):
        P.framework.reset_default_programs()
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            cost = build(P)
        if use_amp:
            A.enable(main)
        progs[P] = (main, startup, cost)
    (jmain, jstart, jcost), (pmain, _, pcost) = progs[jpt], progs[pt]
    assert pmain.to_dict() == jmain.to_dict()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jstart, scope=jscope)
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    return dict(jmain=jmain, jexe=jexe, jscope=jscope, jcost=jcost,
                pmain=pmain, pexe=pt.Executor(pt.CPUPlace()), pscope=pscope,
                pcost=pcost)


def _steps(b, feed, rel):
    for step in range(STEPS):
        jl, = b["jexe"].run(b["jmain"], feed=feed, fetch_list=[b["jcost"]],
                            scope=b["jscope"])
        pl, = b["pexe"].run(b["pmain"], feed=feed, fetch_list=[b["pcost"]],
                            scope=b["pscope"])
        jl, pl = float(np.asarray(jl).ravel()[0]), float(pl.ravel()[0])
        assert abs(pl - jl) <= rel * abs(jl), (step + 1, pl, jl)


@pytest.mark.parametrize("model", ["seq2seq", "stacked_lstm"])
def test_f32_steps_match_the_jax_package(model):
    build, feed = ((_seq2seq, _seq2seq_feed()) if model == "seq2seq"
                   else (_lstm_net, _words_feed()))
    b = _both(build)
    _steps(b, feed, 1e-5)
    params = [p.name for p in b["pmain"].global_block().all_parameters()]
    assert params
    for n in params:
        want = np.asarray(b["jscope"].get(n))
        got = b["pscope"].get(n).numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (n, err)


def _dtypes(b, feed):
    block = b["pmain"].global_block()
    names = [n for n, v in block.vars.items()
             if not v.persistable and n not in feed]
    jout = b["jexe"].run(b["jmain"], feed=feed, fetch_list=names,
                         scope=b["jscope"])
    pout = b["pexe"].run(b["pmain"], feed=feed, fetch_list=names,
                         scope=b["pscope"], return_numpy=False)
    got = {n: str(t.dtype).replace("torch.", "") for n, t in zip(names,
                                                                 pout)}
    want = {n: str(np.asarray(a).dtype) for n, a in zip(names, jout)}
    return block, got, want


def _op_out_dtypes(block, dtypes, op_type, slot):
    return {dtypes[op.output(slot)[0]] for op in block.ops
            if op.type == op_type}


def test_seq2seq_amp_step_dtypes_and_losses():
    """Under amp the port's per-var dtypes equal the JAX package's:
    the products (fc's mul, attention's matmul) bf16, the GRUs and the
    softmax f32, the SeqLen inputs int32 (fed int64, as bench.py feeds
    them); then three steps within 2e-3 relative."""
    feed = _seq2seq_feed()
    b = _both(_seq2seq, use_amp=True)
    block, got, want = _dtypes(b, feed)
    assert got == want
    assert _op_out_dtypes(block, want, "matmul", "Out") == {"bfloat16"}
    assert _op_out_dtypes(block, want, "gru", "Hidden") == {"float32"}
    for op in block.ops:
        if op.type == "gru":
            assert block.var(op.input("SeqLen")[0]).dtype == "int32"
    _steps(b, feed, 2e-3)


def test_conv_net_amp_sequence_conv_computes_in_bf16():
    """sequence_conv's amp role (compute): its output is bf16 in both
    packages, the max pool that follows keeps it, and three steps agree
    within 2e-3 relative."""
    feed = _words_feed()
    b = _both(_conv_net, use_amp=True)
    block, got, want = _dtypes(b, feed)
    assert got == want
    assert _op_out_dtypes(block, want, "sequence_conv", "Out") == \
        {"bfloat16"}
    assert amp.ROLES["sequence_conv"] == "compute"
    _steps(b, feed, 2e-3)


def test_program_flops_count_every_step_of_a_recurrence():
    """The tally counts the new products (matmul, gru; 2 x multiply-adds,
    a grad op 2x its forward) with the feed's padded T. At T = 1 it
    equals the reference auditor's exactly; at T > 1 it exceeds it by
    (T - 1) x the recurrent products of the three GRUs (forward and
    gradient): the reference's scan body counts once (ROADMAP C12)."""
    B, V, E, H = 4, 24, 8, 8
    for T in (1, 5):
        feed = {}
        for n in ("src", "tgt", "nxt"):
            feed[n] = np.ones((B, T, 1), np.int64)
            feed[n + "@SEQLEN"] = np.full((B,), T, np.int32)
        progs = {}
        for P in (jpt, pt):
            P.framework.reset_default_programs()
            cost = _seq2seq(P, V, E, H)
            progs[P] = (P.default_main_program(),
                        P.default_startup_program(), cost)
        jmain, jstart, jcost = progs[jpt]
        jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        jexe.run(jstart, scope=jscope)
        ref = jintrospect.program_flops(jmain, feed=feed,
                                        fetch_list=[jcost.name],
                                        scope=jscope, executor=jexe)
        got = introspect.program_flops(progs[pt][0], feed)
        per_step = 3 * 3 * 2 * B * H * 3 * H    # 3 GRUs, fwd + 2x grad
        assert got - ref == (T - 1) * per_step > -1, (T, got, ref)
        assert ref > 0
    # the matmuls are counted: Tt x Ts scores and the context product
    ops = introspect.program_op_costs(progs[pt][0], feed)
    mm = [f for _, t, f, _ in ops if t == "matmul"]
    assert mm == [2 * B * T * T * 2 * H] * 2
