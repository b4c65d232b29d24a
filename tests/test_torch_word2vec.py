"""Word2vec's N-gram model (models/word2vec.py::ngram_lm's body: four
context words through one shared embedding table, concat, a sigmoid fc)
with its three heads in the port against the JAX package, on the CPU:
the softmax head (ngram_lm's own), `layers.nce` (its negatives fed as
CustomSamples, so both packages score the same ids) and
`layers.hsigmoid`.

For each head, at a few narrow widths: the same Program dict in both
packages; from the JAX package's initial parameters, two SGD steps with
the loss within 1e-5 relative and every parameter's gradient within
1e-4 of its largest element at each step. Then the port trains alone
(the mirror of tests/test_ctc_sampled_losses.py's training checks): the
mean loss of the last 10 of 150 Adam steps below that of the first 10,
NCE with its own uniform negatives drawn from the executor's generator.
The ids are synthetic with a learnable rule (the next word is the sum of
the context ids modulo V, as tests/test_book_models.py's word2vec).
"""

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_REL, GRAD_REL = 1e-5, 1e-4
NEG = 5


def ngram_program(P, head, V, emb, hid, custom=True, opt=None):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        words = [P.layers.data(f"w{i}", [1], dtype="int64")
                 for i in range(4)]
        nxt = P.layers.data("next", [1], dtype="int64")
        embs = [P.layers.embedding(input=w, size=[V, emb],
                                   param_attr=P.ParamAttr(name="shared_w"))
                for w in words]
        hidden = P.layers.fc(input=P.layers.concat(input=embs, axis=1),
                             size=hid, act="sigmoid")
        if head == "softmax":
            probs = P.layers.fc(input=hidden, size=V, act="softmax")
            cost = P.layers.cross_entropy(probs, nxt)
        elif head == "nce":
            neg = P.layers.data("neg", [NEG], dtype="int64") if custom \
                else None
            cost = P.layers.nce(hidden, nxt, V, num_neg_samples=NEG,
                                custom_samples=neg)
        else:
            cost = P.layers.hsigmoid(hidden, nxt, V)
        avg = P.layers.mean(cost)
        _, pg = (opt or P.SGDOptimizer(0.5)).minimize(avg)
    return main, startup, avg, pg


def feed_of(rs, B, V, head):
    ctx = [rs.randint(0, V, (B, 1)).astype(np.int64) for _ in range(4)]
    feed = {f"w{i}": c for i, c in enumerate(ctx)}
    feed["next"] = (sum(c[:, 0] for c in ctx) % V).astype(np.int64)[:, None]
    if head == "nce":
        feed["neg"] = rs.randint(0, V, (B, NEG)).astype(np.int64)
    return feed


def _close(p, j, rel):
    tol = rel * max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(p, j, rtol=0, atol=tol)


@pytest.mark.parametrize("head", ["softmax", "nce", "hsigmoid"])
@pytest.mark.parametrize("V,emb,hid,B", [(40, 8, 16, 32), (57, 16, 24, 20)],
                         ids=["V40", "V57"])
def test_two_steps_match_the_jax_package(head, V, emb, hid, B):
    progs = {P: ngram_program(P, head, V, emb, hid) for P in (jpt, pt)}
    assert progs[pt][0].to_dict() == progs[jpt][0].to_dict()
    assert progs[pt][1].to_dict() == progs[jpt][1].to_dict()
    jmain, jstart, javg, jpg = progs[jpt]
    jscope = jpt.Scope()
    jexe = jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = {n: np.asarray(jscope.get(n))
              for n, v in jstart.global_block().vars.items()
              if v.persistable}
    pmain, _, pavg, ppg = progs[pt]
    pscope = scope_from_numpy(params, "cpu")
    pexe = pt.Executor(pt.CPUPlace())
    rs = np.random.RandomState(11)
    for _ in range(2):
        feed = feed_of(rs, B, V, head)
        j = jexe.run(jmain, feed=feed,
                     fetch_list=[javg] + [g.name for _, g in jpg],
                     scope=jscope)
        p = pexe.run(pmain, feed=feed,
                     fetch_list=[pavg] + [g.name for _, g in ppg],
                     scope=pscope)
        np.testing.assert_allclose(p[0], np.asarray(j[0]), rtol=LOSS_REL)
        for jg, pgv in zip(j[1:], p[1:]):
            _close(pgv, np.asarray(jg), GRAD_REL)
            assert np.abs(np.asarray(jg)).max() > 0


@pytest.mark.parametrize("head", ["nce", "hsigmoid"])
def test_port_trains_each_sampled_head(head):
    V, B = 40, 64
    main, startup, avg, _ = ngram_program(
        pt, head, V, 16, 32, custom=False, opt=pt.AdamOptimizer(2e-2))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(5)
    feeds = [feed_of(rs, B, V, head) for _ in range(4)]
    losses = []
    for i in range(150):
        out, = exe.run(main, feed=feeds[i % 4], fetch_list=[avg],
                       scope=scope)
        losses.append(float(np.asarray(out).ravel()[0]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10]), losses
