"""The port's beam search (paddle_tpu_torch/ops/beam_ops.py) against the
JAX package's (paddle_tpu/ops/beam_ops.py) on the CPU: one expansion
step, the `beam_search` and `beam_search_decode` ops, and the fused
`gru_attention_beam_decode` of the seq2seq-attention model.

Selected ids, parents, finished flags, ranked sentences and lengths are
compared EXACTLY, also under tied scores: a step's top-k puts the lower
flat index first among equal scores (`jax.lax.top_k`), the final ranking
is a stable argsort of -scores, and a sentence ends at its first end
token. The tie cases are built to tie: uniform probabilities, finished
beams (whose -1e9 candidates tie in bulk), the first step's masked
beams, and a decoder whose output layer is zero (every token equally
likely at every step). Scores are within 1e-5 absolute (the two
packages' log / softmax differ in the last bits); on the tied cases
they are equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import beam_ops as jbeam
from paddle_tpu_torch.ops import beam_ops as pbeam
from paddle_tpu_torch.ops import registry as preg
from torch_parity_helpers import check_outputs, run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_registered_ops():
    for n in ("beam_search", "beam_search_decode",
              "gru_attention_beam_decode"):
        assert preg.has_op(n) and not preg.get_op(n).differentiable
    # the legacy generator decodes only; the host beam cost trains
    assert not preg.get_op("legacy_beam_generate").differentiable
    assert preg.get_op("cross_entropy_over_beam").differentiable


def _step_both(pre, logp, fin, end_id, K, first):
    j = jbeam.beam_step(jnp, jnp.asarray(pre), jnp.asarray(logp),
                        jnp.asarray(fin), end_id, K, first_step=first)
    p = pbeam.beam_step(torch.from_numpy(pre), torch.from_numpy(logp),
                        torch.from_numpy(fin), end_id, K, first_step=first)
    return [np.asarray(a) for a in j], [t.numpy() for t in p]


@pytest.mark.parametrize("first", [False, True], ids=["step", "first"])
def test_beam_step_ties_take_the_lower_flat_index(first):
    """Log-probs on a coarse grid (many exact ties), a third of the beams
    finished, equal cumulative scores: tokens, parents, scores and
    finished flags equal the reference's exactly."""
    rng = np.random.RandomState(1)
    B, K, V, end_id = 3, 4, 7, 2
    logp = -rng.randint(0, 3, (B, K, V)).astype(np.float32)
    pre = np.zeros((B, K), np.float32)
    fin = rng.rand(B, K) < 0.34
    j, p = _step_both(pre, logp, fin, end_id, K, first)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(b, a)


def test_all_beams_finished_keep_their_order():
    """Every beam finished: each contributes end_id at +0 and the rest
    tie at -1e9; the survivors are the beams in order, unchanged."""
    B, K, V = 2, 3, 5
    pre = np.array([[-1., -1., -2.], [-3., -3., -3.]], np.float32)
    logp = np.full((B, K, V), -0.5, np.float32)
    fin = np.ones((B, K), bool)
    j, p = _step_both(pre, logp, fin, 1, K, False)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(p[1], [[0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(p[0], np.ones((B, K)))


@pytest.mark.parametrize("case", ["random", "uniform-ties", "first-step"])
def test_beam_search_op(case):
    """tests/test_beam_search.py's step inputs (seed 0, B 3, K 4, V 11,
    end_id 2), then uniform probabilities (every candidate of a beam
    ties) and a first step."""
    rng = np.random.RandomState(0)
    B, K, V = 3, 4, 11
    probs = rng.dirichlet(np.ones(V), size=(B, K)).astype(np.float32)
    pre = rng.randn(B, K).astype(np.float32)
    fin = (rng.rand(B, K) < 0.3).astype(np.int32)
    if case == "uniform-ties":
        probs = np.full((B, K, V), 1.0 / V, np.float32)
        pre = np.round(pre)
    attrs = {"beam_size": K, "end_id": 2,
             "is_first_step": case == "first-step"}
    jout, pout, _, _ = run_both(
        "beam_search", {"PreScores": [pre], "Probs": [probs],
                        "PreFinished": [fin]}, attrs)
    check_outputs(jout, pout)
    for slot in ("SelectedIds", "ParentIdx", "Finished"):
        assert pout[slot][0].dtype == torch.int32


def test_beam_search_decode_golden_and_ranking_ties():
    # tests/test_beam_search.py's hand-built parent chains
    ids = np.array([[[5, 7]], [[3, 4]], [[9, 8]]], np.int32)
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int32)
    scores = np.array([[2.0, 1.0]], np.float32)
    jout, pout, _, _ = run_both("beam_search_decode",
                                {"Ids": [ids], "ParentIdx": [parents],
                                 "FinalScores": [scores]})
    check_outputs(jout, pout)
    np.testing.assert_array_equal(pout["SentenceIds"][0][0].numpy(),
                                  [[7, 3, 9], [5, 4, 8]])
    # random chains, scores with ties: the stable ranking keeps beam order
    rng = np.random.RandomState(2)
    L, B, K = 5, 3, 4
    ids = rng.randint(0, 9, (L, B, K)).astype(np.int32)
    parents = rng.randint(0, K, (L, B, K)).astype(np.int32)
    scores = rng.randint(-2, 1, (B, K)).astype(np.float32)
    jout, pout, _, _ = run_both("beam_search_decode",
                                {"Ids": [ids], "ParentIdx": [parents],
                                 "FinalScores": [scores]})
    check_outputs(jout, pout)


def _decode_inputs(seed, zero_out=False):
    """A tiny spec: B 3, Ts 5 (ragged source mask), He 8, D 4, E 6,
    V 9."""
    rng = np.random.RandomState(seed)
    B, Ts, He, D, E, V = 3, 5, 8, 4, 6, 9

    def u(*shape, s=0.5):
        return rng.uniform(-s, s, shape).astype(np.float32)

    mask = (np.arange(Ts)[None, :] < np.array([5, 3, 1])[:, None]).astype(
        np.float32)
    ins = {"EncStates": [u(B, Ts, He, s=1.0)], "SrcMask": [mask],
           "TgtEmb": [u(V, E)], "DecProjW": [u(E, 3 * D)],
           "DecProjB": [u(3 * D, s=0.1)], "GruW": [u(D, 3 * D)],
           "GruB": [u(1, 3 * D, s=0.1)], "AttQueryW": [u(D, He)],
           "AttCombineW": [u(D + He, D)], "AttCombineB": [u(D, s=0.1)],
           "OutW": [u(D, V, s=2.0)], "OutB": [u(V, s=0.5)]}
    if zero_out:
        ins["OutW"] = [np.zeros((D, V), np.float32)]
        ins["OutB"] = [np.zeros((V,), np.float32)]
    return ins


@pytest.mark.parametrize("zero_out", [False, True],
                         ids=["random", "all-tokens-tie"])
@pytest.mark.parametrize("K,L", [(3, 6), (1, 4)], ids=["beam3", "greedy"])
def test_gru_attention_beam_decode(zero_out, K, L):
    """Ids and lengths exact, scores within 1e-5; with a zero output
    layer every token ties at every step and the ids still equal the
    reference's."""
    ins = _decode_inputs(3, zero_out)
    attrs = {"beam_size": K, "max_len": L, "bos_id": 1, "end_id": 2}
    jout, pout, _, _ = run_both("gru_attention_beam_decode", ins, attrs)
    check_outputs(jout, pout)
    assert pout["SentenceIds"][0].shape == (3, K, L)
    if zero_out:
        np.testing.assert_array_equal(pout["SentenceScores"][0].numpy(),
                                      np.asarray(jout["SentenceScores"][0]))
