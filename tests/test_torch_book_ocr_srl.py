"""The last three "book" models trained in the port on the CPU.

The port twins of tests/test_book_models.py's
test_label_semantic_roles_crf (embedding -> bi-LSTM -> linear_chain_crf,
Viterbi-decoded), test_ocr_crnn_ctc_trains_and_decodes (conv -> width
sequence -> row_conv -> CTC, greedy-decoded) and
test_ocr_crnn_default_lens_dynamic_batch (the full-width lengths made
in the graph per batch row): the same synthetic data, steps, optimizer
and thresholds (the SRL loss below 0.3 of its first value and > 0.9 of
the decoded tags right; the OCR loss below 0.15 of its first and the
decoded transcriptions equal to the labels), with the port's own
initialisation. Each model's main and startup Program dicts equal the
JAX front end's.

Also the OCR model's first step on the JAX package's parameters: the
loss within 1e-5 relative and every parameter's gradient within 1e-4 of
its largest element, and the SRL decode on those parameters equal to
the JAX package's path.
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

_SEED = 1234

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _fresh_programs():
    for P in (jpt, pt):
        P.framework.reset_default_programs()
    yield


def _same_program_as_reference(build):
    """`build(P)` in both packages: equal main and startup Program dicts.
    Leaves the port's programs as the default ones; returns what
    `build(pt)` returned."""
    jpt.framework.reset_default_programs()
    build(jpt)
    jmain = jpt.default_main_program().to_dict()
    jstart = jpt.default_startup_program().to_dict()
    pt.framework.reset_default_programs()
    out = build(pt)
    assert pt.default_main_program().to_dict() == jmain
    assert pt.default_startup_program().to_dict() == jstart
    return out


def _jax_params():
    """The JAX package's parameters after its startup program (the
    default programs `build(jpt)` made)."""
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    exe.run(jpt.default_startup_program(), scope=scope)
    return {k: np.array(scope.get(k)) for k in scope.keys()
            if not k.startswith("__")}


def _seq_batch(rng, B, T, vocab):
    lens = rng.randint(2, T + 1, (B,)).astype(np.int32)
    toks = rng.randint(1, vocab, (B, T, 1)).astype(np.int64)
    mask = np.arange(T)[None, :] < lens[:, None]
    toks[~mask] = 0
    return toks, lens


def _srl_data():
    rng = np.random.RandomState(_SEED)
    toks, lens = _seq_batch(rng, 12, 6, 32)
    tags = (toks[:, :, 0] % 4).astype(np.int64)
    mask = np.arange(6)[None, :] < lens[:, None]
    tags[~mask] = 0
    feeds = {"words": toks, "words@SEQLEN": lens,
             "tags": tags.reshape(12, 6, 1), "tags@SEQLEN": lens}
    return feeds, tags, mask


def _srl(P, train=True):
    vocab, K, hid = 32, 4, 16
    words = P.layers.data("words", [1], dtype="int64", lod_level=1)
    label = P.layers.data("tags", [1], dtype="int64", lod_level=1)
    emb = P.layers.embedding(input=words, size=[vocab, 16])
    fwd_proj = P.layers.fc(input=emb, size=hid * 4)
    fwd, _ = P.layers.dynamic_lstm(input=fwd_proj, size=hid * 4,
                                   use_peepholes=False)
    bwd_proj = P.layers.fc(input=emb, size=hid * 4)
    bwd, _ = P.layers.dynamic_lstm(input=bwd_proj, size=hid * 4,
                                   use_peepholes=False, is_reverse=True)
    feat = P.layers.concat([fwd, bwd], axis=2)
    emission = P.layers.fc(input=feat, size=K, num_flatten_dims=2)
    crf_cost = P.layers.linear_chain_crf(
        input=emission, label=label, param_attr=P.ParamAttr(name="crfw"))
    cost = P.layers.mean(crf_cost)
    decode = P.layers.crf_decoding(input=emission,
                                   param_attr=P.ParamAttr(name="crfw"))
    if train:
        P.AdamOptimizer(learning_rate=3e-2).minimize(cost)
    return cost, decode


def test_label_semantic_roles_crf():
    feeds, tags, mask = _srl_data()
    cost, decode = _same_program_as_reference(_srl)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    first = None
    for _ in range(120):
        loss, path = exe.run(feed=feeds, fetch_list=[cost, decode],
                             scope=scope)
        first = float(loss[0]) if first is None else first
    last = float(loss[0])
    assert np.isfinite(last) and last < first * 0.3, (first, last)
    agree = ((path == tags) & mask).sum() / mask.sum()
    assert agree > 0.9, agree


def test_label_semantic_roles_decode_equals_jax_package():
    feeds, _tags, _mask = _srl_data()
    jcost, jdecode = _srl(jpt, train=False)
    params = _jax_params()
    jout = jpt.Executor(jpt.CPUPlace()).run(
        feed=feeds, fetch_list=[jcost, jdecode],
        scope=_jax_scope(params))
    cost, decode = _srl(pt, train=False)
    pout = pt.Executor(pt.CPUPlace()).run(
        feed=feeds, fetch_list=[cost, decode],
        scope=scope_from_numpy(params, "cpu"))
    np.testing.assert_allclose(pout[0], jout[0], rtol=1e-5)
    np.testing.assert_array_equal(pout[1], jout[1])


def _jax_scope(params):
    scope = jpt.Scope()
    for k, v in params.items():
        scope.set(k, v)
    return scope


_OCR_B, _OCR_H, _OCR_W, _OCR_C = 2, 8, 32, 4


def _ocr(P, train=True):
    """The OCR program: with `train` Adam's update, else the gradients
    (returned as a list after the cost and the decoded ids)."""
    img = P.layers.data("img", [1, _OCR_H, _OCR_W])
    lens = P.layers.data("lens", [_OCR_B], dtype="int32",
                         append_batch_size=False)
    lab = P.layers.data("lab", [], dtype="int64", lod_level=1)
    cost, logits = P.models.ocr.crnn_ctc_cost(img, lab, num_classes=_OCR_C,
                                              image_lens=lens)
    decoded = P.layers.ctc_greedy_decoder(logits, blank=0)
    if not train:
        return cost, decoded, [g for _p, g in P.backward.append_backward(cost)]
    P.AdamOptimizer(learning_rate=5e-3).minimize(cost)
    return cost, decoded


def _ocr_feed():
    rng = np.random.RandomState(_SEED)
    labels = np.array([[1, 2, 3], [3, 1, 2]], np.int64)
    return {"img": rng.rand(_OCR_B, 1, _OCR_H, _OCR_W).astype(np.float32),
            "lens": np.full([_OCR_B], _OCR_W, np.int32), "lab": labels,
            "lab@SEQLEN": np.array([3, 3], np.int32)}, labels


def test_ocr_crnn_ctc_trains_and_decodes():
    feed, labels = _ocr_feed()
    cost, decoded = _same_program_as_reference(_ocr)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    first = None
    for _ in range(150):
        loss, = exe.run(feed=feed, fetch_list=[cost], scope=scope)
        first = float(np.ravel(loss)[0]) if first is None else first
    last = float(np.ravel(loss)[0])
    assert last < first * 0.15, (first, last)
    dec, dlen = exe.run(feed=feed, fetch_list=[decoded, decoded.seq_len_var],
                        scope=scope)
    for b in range(_OCR_B):
        assert list(dec[b, :dlen[b]]) == list(labels[b]), (b, dec[b])


def test_ocr_first_step_equals_jax_package():
    """One step of the OCR training program on the JAX package's
    parameters: the loss and every parameter's gradient."""
    feed, _labels = _ocr_feed()
    grads = {}
    for P in (jpt, pt):
        P.framework.reset_default_programs()
        cost, _dec, pgrads = _ocr(P, train=False)
        fetch = [cost] + pgrads
        if P is jpt:
            params = _jax_params()
            scope = _jax_scope(params)
        else:
            scope = scope_from_numpy(params, "cpu")
        grads[P] = P.Executor(P.CPUPlace()).run(feed=feed, fetch_list=fetch,
                                                scope=scope)
    j, p = grads[jpt], grads[pt]
    np.testing.assert_allclose(p[0], j[0], rtol=1e-5)
    assert len(p) > 4
    for jg, pg in zip(j[1:], p[1:]):
        tol = 1e-4 * max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(pg, jg, rtol=0, atol=tol)


def test_ocr_crnn_default_lens_dynamic_batch():
    B, H, W, C = 3, 8, 16, 4

    def build(P):
        img = P.layers.data("img", [1, H, W])
        return P.models.ocr.crnn_ctc(img, num_classes=C)

    logits = _same_program_as_reference(build)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(_SEED)
    out, lens = exe.run(feed={"img": rng.rand(B, 1, H, W).astype(
        np.float32)}, fetch_list=[logits, logits.seq_len_var])
    assert out.shape[0] == B
    assert list(np.asarray(lens)) == [W // 4] * B
