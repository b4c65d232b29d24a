"""Legacy in-config generation (`trainer_config_helpers.beam_search` +
`GeneratedInput`, the `legacy_beam_generate` op) in the port against the
JAX package and a numpy beam, on the CPU.

- A planted Markov chain over words (tests/test_legacy_generation.py's
  `_np_beam`, written here as an inline config with the step of the
  reference's sample_trainer_rnn_gen.conf: scores = exp((E[prev] @ T) @
  E^T)), greedy and beam 2: the ids equal the numpy beam's and the JAX
  package's exactly, the lengths stop at the first end token, the
  scores within 1e-5 relative of the JAX package's.
- The memory decoder of tests/test_legacy_generation.py (a StaticInput
  context, a GRU memory re-gathered by parent beam each step, a softmax
  out), greedy and beam 3, from the JAX package's weights: ids and
  lengths exact, scores within 1e-5.
- A tie: the out layer's weights zero, every token ties at every step;
  the ids still equal the JAX package's (ROADMAP C14's rules: the lower
  flat index first, a stable ranking).
"""

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import trainer_config_helpers as jtch
import paddle_tpu_torch as pt
from paddle_tpu_torch import trainer_config_helpers as ptch
from paddle_tpu_torch.weights import scope_from_numpy

V, BOS, EOS, L = 5, 0, 4, 10

MARKOV = """
beam = get_config_arg('beam', int, 1)
settings(batch_size=3, learning_rate=0)
dummy = data_layer(name='dummy_data_input', size=2)
gen_inputs = [StaticInput(input=dummy),
              GeneratedInput(size=%(V)d, embedding_name='wordvec',
                             embedding_size=%(V)d)]

def step(dummy_memory, predict_word):
    with mixed_layer(size=%(V)d) as layer_output:
        layer_output += full_matrix_projection(
            input=predict_word, param_attr=ParamAttr(name='transtable'))
    with mixed_layer(size=%(V)d, act=ExpActivation()) as out:
        out += trans_full_matrix_projection(
            input=layer_output, param_attr=ParamAttr(name='wordvec'))
    return out

outputs(beam_search(name='rnn_gen', step=step, input=gen_inputs,
                    bos_id=%(BOS)d, eos_id=%(EOS)d, beam_size=beam,
                    num_results_per_sample=beam, max_length=%(L)d))
""" % {"V": V, "BOS": BOS, "EOS": EOS, "L": L}

DECODER = """
beam = get_config_arg('beam', int, 3)
settings(batch_size=4, learning_rate=0)
ctx = data_layer(name='ctx', size=6)

gen_in = [StaticInput(input=ctx, size=6),
          GeneratedInput(size=7, embedding_name='gen_emb',
                         embedding_size=6)]

def step(ctx_in, word_emb):
    state = memory(name='dec', size=6)
    merged = mixed_layer(size=18,
                         input=[full_matrix_projection(input=ctx_in),
                                full_matrix_projection(input=word_emb)])
    h = gru_step_layer(input=merged, output_mem=state, size=6,
                       name='dec')
    with mixed_layer(size=7, act=SoftmaxActivation()) as out:
        out += full_matrix_projection(input=h)
    return out

gen = beam_search(name='g', step=step, input=gen_in, bos_id=0,
                  eos_id=6, beam_size=beam, max_length=8)
outputs(gen)
"""


def _np_beam(B, K, T, E):
    """tests/test_legacy_generation.py's numpy beam over the planted
    chain: logits = (E[prev] @ T) @ E^T, first expansion from beam 0."""
    results = []
    for _ in range(B):
        beams = [([BOS], 0.0, False)] + [([BOS], -1e9, True)] * (K - 1)
        for _t in range(L):
            cands = []
            for k, (toks, sc, fin) in enumerate(beams):
                if fin:
                    cands.append((sc, k, EOS))
                    continue
                logp = (E[np.asarray([toks[-1]])] @ T @ E.T)[0]
                for w in range(V):
                    cands.append((sc + logp[w], k, w))
            cands.sort(key=lambda c: -c[0])
            beams = [(beams[k][0] + [w], sc, beams[k][2] or w == EOS)
                     for sc, k, w in cands[:K]]
        beams.sort(key=lambda bm: -bm[1])
        results.append([bm[0][1:] for bm in beams])
    return results


def _generate(P, src, args, feed, init=None, override=None):
    """Parse `src` into fresh programs of package P, initialise (the JAX
    startup, or `init` carried into the port), apply `override`, run
    the generator; returns (ids, scores, lens, the state used)."""
    P.framework.reset_default_programs()
    tch = jtch if P is jpt else ptch
    rec = tch.parse_config(src, config_args=dict(args))
    ids = rec.outputs[-1]
    startup = P.framework.default_startup_program()
    if P is jpt:
        exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        exe.run(startup, scope=scope)
        init = {k: np.array(scope.get(k)) for k in scope.keys()
                if not k.startswith("__")}
        init.update(override or {})
        for k, v in init.items():
            scope.set(k, v)
    else:
        exe, scope = pt.Executor(pt.CPUPlace()), scope_from_numpy(init,
                                                                  "cpu")
    got, scores, lens = exe.run(
        rec.program, feed=feed,
        fetch_list=[ids, ids.scores_var, ids.lens_var], scope=scope)
    return np.asarray(got), np.asarray(scores), np.asarray(lens), init


def _both(src, args, feed, override=None):
    jout = _generate(jpt, src, args, feed, override=override)
    pout = _generate(pt, src, args, feed, init=jout[3])
    return jout, pout


@pytest.mark.parametrize("beam", [1, 2])
def test_planted_chain_matches_numpy_and_the_reference(beam):
    rng = np.random.RandomState(7)
    T = rng.randn(V, V).astype(np.float32)
    E = rng.randn(V, V).astype(np.float32)
    B = 3
    feed = {"dummy_data_input": np.zeros((B, 2), np.float32)}
    (jids, jsc, jlens, _), (ids, sc, lens, _) = _both(
        MARKOV, {"beam": beam}, feed,
        override={"transtable": T, "wordvec": E})
    assert ids.shape == (B, beam, L) and ids.dtype == np.int64
    assert lens.dtype == np.int64 and sc.dtype == np.float32
    want = _np_beam(B, beam, T.astype(np.float64), E.astype(np.float64))
    for b in range(B):
        for k in range(beam):
            np.testing.assert_array_equal(ids[b, k], want[b][k])
            row = list(ids[b, k])
            assert lens[b, k] == (row.index(EOS) + 1 if EOS in row else L)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_allclose(sc, jsc, rtol=1e-5)


@pytest.mark.parametrize("beam", [1, 3])
def test_memory_decoder_matches_the_reference(beam):
    feed = {"ctx": np.random.RandomState(0).randn(4, 6).astype(np.float32)}
    (jids, jsc, jlens, _), (ids, sc, lens, _) = _both(
        DECODER, {"beam": beam}, feed)
    assert ids.shape == (4, beam, 8)
    assert ids.min() >= 0 and ids.max() < 7
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_allclose(sc, jsc, rtol=1e-5)
    # ranked, highest first
    assert np.all(np.diff(sc, axis=1) <= 1e-5)


def test_tied_tokens_keep_the_reference_order():
    """The out layer's weight (fc_2.w_0, the decoder's only [6, 7]
    parameter) zero: a uniform softmax, so every token ties at every
    step and only the tie rules decide the ids."""
    feed = {"ctx": np.random.RandomState(1).randn(4, 6).astype(np.float32)}
    zero = {"fc_2.w_0": np.zeros((6, 7), np.float32)}
    (jids, jsc, jlens, init), (ids, sc, lens, _) = _both(
        DECODER, {"beam": 3}, feed, override=zero)
    assert [k for k, v in init.items() if v.shape == (6, 7)] == ["fc_2.w_0"]
    np.testing.assert_allclose(sc, np.full_like(sc, 8 * np.log(1 / 7)),
                               rtol=1e-5)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lens, jlens)
