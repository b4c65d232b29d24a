"""CTC, the linear-chain CRF and chunk_eval in the port against the JAX
package's lowerings on the same numpy inputs, on the CPU.

  * `warpctc`: the loss and the gradient of the logits, with repeated
    labels (the skip transition is barred between equal labels), a row
    with LabelLen 0, rows with LogitsLen < T (the alpha freezes, and the
    gradient past a row's length is exactly 0), and norm_by_times; the
    loss also against tests/test_ctc_sampled_losses.py's numpy
    recursion; another blank id.
  * `ctc_align`: merge repeats and drop blanks, exactly, including rows
    where most writes go to the reference's drop sentinel (index T).
  * `linear_chain_crf`: the NLL and Alpha, and the gradients of the
    emissions and the transition; the NLL also against a brute-force
    enumeration of every path (tests/test_crf_ops.py's).
  * `crf_decoding`: paths exactly, with ties everywhere (every score
    equal: the first maximum wins in the back-pointers and the last
    tag), and the 0/1 mask when a Label is given.
  * `chunk_eval`: the six outputs exactly (the counts are integers),
    and the counts equal the host ChunkEvaluator's on every row.

Tolerances (tests/torch_parity_helpers.py): 1e-5 absolute on float32
forward values, gradients within 1e-4 of each gradient's largest
element; integer outputs exact.
"""

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu import evaluator as jev
from paddle_tpu_torch import evaluator as ev
from test_ctc_sampled_losses import np_ctc_align, np_ctc_loss
from torch_parity_helpers import check_grads, check_outputs, run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ctc_inputs(seed, B=4, T=7, U=3, C=5, dtype=np.float32):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, C) * 2.0).astype(dtype)
    labels = rng.randint(1, C, size=(B, U)).astype(np.int32)
    labels[0] = [2, 2, 3]                  # a repeat: no skip between
    labels[1] = [4, 4, 4]
    label_lens = np.array([3, 3, 0, 2], np.int32)
    labels[2] = 0                          # LabelLen 0: padding only
    logit_lens = np.array([7, 6, 4, 5], np.int32)
    return {"Logits": [logits], "LogitsLen": [logit_lens],
            "Label": [labels], "LabelLen": [label_lens]}


@pytest.mark.parametrize("norm", [False, True], ids=["sum", "norm_by_times"])
def test_warpctc_loss_and_grad(norm):
    ins = _ctc_inputs(0)
    jout, pout, jg, pg = run_both("warpctc", ins,
                                  {"blank": 0, "norm_by_times": norm},
                                  out="Loss", grad=("Logits",))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    want = np_ctc_loss(ins["Logits"][0], ins["LogitsLen"][0],
                       ins["Label"][0], ins["LabelLen"][0])
    if norm:
        want = want / ins["LogitsLen"][0]
    np.testing.assert_allclose(pout["Loss"][0].numpy()[:, 0], want,
                               rtol=1e-5, atol=1e-5)
    # no gradient past a row's length
    g = pg[0].numpy()
    for b, n in enumerate(ins["LogitsLen"][0]):
        assert np.abs(g[b, n:]).max(initial=0.0) == 0.0


def test_warpctc_another_blank():
    ins = _ctc_inputs(1)
    jout, pout, jg, pg = run_both("warpctc", ins, {"blank": 4},
                                  out="Loss", grad=("Logits",))
    check_outputs(jout, pout)
    check_grads(jg, pg)


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "keep"])
def test_ctc_align(merge):
    rng = np.random.RandomState(2)
    B, T = 5, 9
    ids = rng.randint(0, 4, (B, T)).astype(np.int32)
    ids[1] = 0                              # all blank: every write drops
    ids[2] = [3, 3, 3, 0, 3, 3, 1, 1, 2]
    in_lens = np.array([9, 9, 9, 4, 0], np.int32)
    jout, pout, _, _ = run_both("ctc_align",
                                {"Input": [ids], "InLen": [in_lens]},
                                {"blank": 0, "merge_repeated": merge})
    check_outputs(jout, pout)
    if merge:
        want = np_ctc_align(ids, in_lens)
        out, lens = pout["Output"][0].numpy(), pout["OutLen"][0].numpy()
        for b in range(B):
            assert list(out[b, :lens[b]]) == want[b]
            assert not out[b, lens[b]:].any()


_K = 3
_LENS = np.asarray([4, 2, 3, 0], np.int64)


def _crf_inputs(seed, B=4, T=4, K=_K):
    rng = np.random.RandomState(seed)
    return {"Emission": [rng.uniform(-1, 1, (B, T, K)).astype(np.float32)],
            "Transition": [rng.uniform(-.5, .5, (K + 2, K)).astype(
                np.float32)],
            "Label": [rng.randint(0, K, (B, T)).astype(np.int64)],
            "SeqLen": [_LENS]}


def _brute_nll(em, label, lens, trans):
    start, end, w = trans[0], trans[1], trans[2:]

    def score(b, tags):
        s = start[tags[0]] + em[b, 0, tags[0]]
        for t in range(1, len(tags)):
            s += w[tags[t - 1], tags[t]] + em[b, t, tags[t]]
        return s + end[tags[-1]]

    out = []
    for b, L in enumerate(lens):
        if L == 0:
            continue
        scores = np.array([score(b, p) for p in
                           itertools.product(range(em.shape[2]), repeat=L)],
                          np.float64)
        out.append(np.logaddexp.reduce(scores) - score(b, label[b, :L]))
    return np.array(out)


@pytest.mark.parametrize("label_3d", [False, True], ids=["BT", "BT1"])
def test_linear_chain_crf(label_3d):
    ins = _crf_inputs(83)
    if label_3d:
        ins["Label"] = [ins["Label"][0][..., None]]
    jout, pout, jg, pg = run_both("linear_chain_crf", ins,
                                  out=("LogLikelihood", "Alpha"),
                                  grad=("Emission", "Transition"))
    check_outputs(jout, pout)
    check_grads(jg, pg)
    nll = pout["LogLikelihood"][0].numpy()[:, 0]
    em, tr = ins["Emission"][0].astype(np.float64), ins["Transition"][0]
    np.testing.assert_allclose(
        nll[_LENS > 0], _brute_nll(em, ins["Label"][0].reshape(4, 4), _LENS,
                                   tr.astype(np.float64)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_label", [False, True], ids=["path", "mask"])
def test_crf_decoding(with_label):
    ins = _crf_inputs(84)
    if not with_label:
        del ins["Label"]
    jout, pout, _, _ = run_both("crf_decoding", ins)
    check_outputs(jout, pout)
    assert pout["ViterbiPath"][0].dtype == torch.int64


@pytest.mark.parametrize("with_label", [False, True], ids=["path", "mask"])
def test_crf_decoding_ties_take_the_first_maximum(with_label):
    """Every emission and transition score equal: every path ties. The
    reference's jnp.argmax takes the first maximum, so the decoded path
    is all tag 0; the port's must be too."""
    B, T, K = 3, 5, 4
    ins = {"Emission": [np.zeros((B, T, K), np.float32)],
           "Transition": [np.full((K + 2, K), 0.25, np.float32)],
           "SeqLen": [np.asarray([5, 3, 1], np.int64)]}
    if with_label:
        ins["Label"] = [np.asarray([[0, 1, 0, 0, 2], [0, 0, 3, 0, 0],
                                    [1, 0, 0, 0, 0]], np.int64)]
    jout, pout, _, _ = run_both("crf_decoding", ins)
    check_outputs(jout, pout)
    if not with_label:
        assert not pout["ViterbiPath"][0].numpy().any()
    # ties in the middle of a path: one tag leads at t = 0 only
    ins = {"Emission": [np.zeros((B, T, K), np.float32)],
           "Transition": [np.zeros((K + 2, K), np.float32)],
           "SeqLen": [np.asarray([5, 3, 1], np.int64)]}
    ins["Emission"][0][:, 0, 2] = 1.0
    jout, pout, _, _ = run_both("crf_decoding", ins)
    check_outputs(jout, pout)


def _chunk_tags(rng, B, T, n_types):
    """Random IOB tags: B-, I- and O tags, with runs, I-tags of the wrong
    type and I-tags after O (which start no chunk)."""
    return rng.randint(0, 2 * n_types + 1, (B, T)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_eval_counts_exact(seed):
    rng = np.random.RandomState(seed)
    B, T, n = 6, 12, 3
    inf = _chunk_tags(rng, B, T, n)
    lab = inf.copy()
    flip = rng.rand(B, T) < 0.3
    lab[flip] = _chunk_tags(rng, B, T, n)[flip]
    lens = rng.randint(0, T + 1, (B,)).astype(np.int64)
    lens[0] = T
    ins = {"Inference": [inf[..., None]], "Label": [lab], "SeqLen": [lens]}
    jout, pout, _, _ = run_both("chunk_eval", ins, {"num_chunk_types": n})
    for slot, jv in jout.items():
        np.testing.assert_array_equal(pout[slot][0].numpy(), np.asarray(jv[0]),
                                      err_msg=slot)
    # the counts equal the host evaluators' (both packages')
    host, jhost = ev.ChunkEvaluator(n), jev.ChunkEvaluator(n)
    for b in range(B):
        host.update(inf[b, :lens[b]], lab[b, :lens[b]])
        jhost.update(inf[b, :lens[b]], lab[b, :lens[b]])
    counts = [float(pout[s][0].numpy()[0]) for s in
              ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]
    assert counts == [host.inferred_chunks, host.label_chunks, host.tp]
    assert host.eval() == jhost.eval()
    # no SeqLen: every position counts
    jout, pout, _, _ = run_both("chunk_eval", {"Inference": [inf],
                                               "Label": [lab]},
                                {"num_chunk_types": n})
    for slot, jv in jout.items():
        np.testing.assert_array_equal(pout[slot][0].numpy(), np.asarray(jv[0]))


def test_every_ctc_crf_op_keeps_the_reference_flags():
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg
    for n in ("warpctc", "ctc_align", "linear_chain_crf", "crf_decoding",
              "chunk_eval"):
        assert preg.get_op(n).differentiable == jreg.get_op(n).differentiable
        assert preg.get_op(n).stateful == jreg.get_op(n).stateful

