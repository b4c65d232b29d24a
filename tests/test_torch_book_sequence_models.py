"""The sequence "book" models trained in the port on the CPU.

The port twins of tests/test_book_models.py's sequence tests
(test_understand_sentiment_stacked_lstm, _conv, test_word2vec,
test_recommender_system, test_machine_translation_attention,
test_rnn_encoder_decoder): the same synthetic data, steps, optimizer and
convergence thresholds (last < first * 0.5; 0.6 for the encoder-decoder),
with the port's own initialisation (its generator, not the reference's
stream). Each model's main and startup Program dicts equal the JAX
front end's. Also here: `layers.data` with lod_level 1 and 2, and the
seq2seq decode program saved by one package and loaded by the other
(the pruned inference program keeps the `@SEQLEN` companions), decoding
the same sentences.
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
    """`build(P)` in both packages (fresh default programs): the main
    and startup Program dicts are equal. Leaves the port's programs as
    the default ones and returns what `build(pt)` returned."""
    jpt.framework.reset_default_programs()
    build(jpt)
    jmain = jpt.default_main_program().to_dict()
    jstart = jpt.default_startup_program().to_dict()
    pt.framework.reset_default_programs()
    out = build(pt)
    assert pt.default_main_program().to_dict() == jmain
    assert pt.default_startup_program().to_dict() == jstart
    return out


def _train(cost, feeds, steps):
    """tests/test_book_models.py's _train in the port (the Adam is in
    the built program): (first loss, last loss)."""
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    first = last = None
    for _ in range(steps):
        out = exe.run(feed=feeds, fetch_list=[cost], scope=scope)
        last = float(np.asarray(out[0]).ravel()[0])
        first = last if first is None else first
    assert np.isfinite(last), last
    return first, last


def _seq_batch(rng, B, T, vocab):
    lens = rng.randint(2, T + 1, (B,)).astype(np.int32)
    toks = rng.randint(1, vocab, (B, T, 1)).astype(np.int64)
    mask = np.arange(T)[None, :] < lens[:, None]
    toks[~mask] = 0
    return toks, lens


def _translation_batch(rng, B, Ts, vocab):
    src, lens = _seq_batch(rng, B, Ts, vocab)
    tgt_next = np.zeros_like(src)
    tgt_in = np.zeros_like(src)
    for b in range(B):
        L = lens[b]
        rev = src[b, :L][::-1]
        tgt_next[b, :L] = rev
        tgt_in[b, 1:L] = rev[:L - 1]
    return src, lens, tgt_in, tgt_next


def _classify(model, **kw):
    def build(P):
        words = P.layers.data("words", [1], dtype="int64", lod_level=1)
        label = P.layers.data("label", [1], dtype="int64")
        probs = model(P)(words, vocab_size=64, emb_dim=16, hid_dim=16, **kw)
        cost = P.layers.mean(P.layers.cross_entropy(probs, label))
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost
    return build


@pytest.mark.parametrize("net", ["stacked_lstm_net", "conv_net"])
def test_understand_sentiment(net):
    rng = np.random.RandomState(_SEED)
    toks, lens = _seq_batch(rng, 16, 8, 64)
    y = (toks[:, 0, 0] % 2).astype(np.int64)[:, None]
    cost = _same_program_as_reference(
        _classify(lambda P: getattr(P.models.lstm_text, net)))
    first, last = _train(cost, {"words": toks, "words@SEQLEN": lens,
                                "label": y}, 60)
    assert last < first * 0.5, (first, last)


def test_word2vec():
    rng = np.random.RandomState(_SEED)
    dict_size = 32
    ctx = [rng.randint(0, dict_size, (48, 1)).astype(np.int64)
           for _ in range(4)]
    nxt = (sum(c[:, 0] for c in ctx) % dict_size).astype(np.int64)[:, None]

    def build(P):
        ws = [P.layers.data(f"w{i}", [1], dtype="int64") for i in range(4)]
        label = P.layers.data("next", [1], dtype="int64")
        probs = P.models.word2vec.ngram_lm(ws, dict_size, emb_dim=16,
                                           hidden_size=64)
        cost = P.layers.mean(P.layers.cross_entropy(probs, label))
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost

    cost = _same_program_as_reference(build)
    feeds = {f"w{i}": ctx[i] for i in range(4)}
    feeds["next"] = nxt
    first, last = _train(cost, feeds, 150)
    assert last < first * 0.5, (first, last)


def test_recommender_system():
    rng = np.random.RandomState(_SEED)
    B = 32
    sizes = {"max_uid": 20, "max_gender": 2, "max_age": 7, "max_job": 10,
             "max_movie": 30, "max_category": 8, "max_title": 40}
    uid = rng.randint(0, 20, (B, 1)).astype(np.int64)
    gender = rng.randint(0, 2, (B, 1)).astype(np.int64)
    age = rng.randint(0, 7, (B, 1)).astype(np.int64)
    job = rng.randint(0, 10, (B, 1)).astype(np.int64)
    movie = rng.randint(0, 30, (B, 1)).astype(np.int64)
    cats, cat_lens = _seq_batch(rng, B, 3, 8)
    titles, title_lens = _seq_batch(rng, B, 5, 40)
    rating = ((uid[:, 0] + movie[:, 0]) % 5 + 1).astype(np.float32)[:, None]

    def build(P):
        v = {n: P.layers.data(n, [1], dtype="int64")
             for n in ("uid", "gender", "age", "job", "movie")}
        cat_v = P.layers.data("cats", [1], dtype="int64", lod_level=1)
        title_v = P.layers.data("titles", [1], dtype="int64", lod_level=1)
        rating_v = P.layers.data("rating", [1])
        R = P.models.recommender
        usr = R.user_net(v["uid"], v["gender"], v["age"], v["job"], sizes)
        mov = R.movie_net(v["movie"], cat_v, title_v, sizes)
        cost = R.recommender_cost(usr, mov, rating_v)
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost

    cost = _same_program_as_reference(build)
    feeds = {"uid": uid, "gender": gender, "age": age, "job": job,
             "movie": movie, "cats": cats, "cats@SEQLEN": cat_lens,
             "titles": titles, "titles@SEQLEN": title_lens,
             "rating": rating}
    first, last = _train(cost, feeds, 120)
    assert last < first * 0.5, (first, last)


def _translation_feed(vocab, B, Ts):
    rng = np.random.RandomState(_SEED)
    src, lens, tgt_in, tgt_next = _translation_batch(rng, B, Ts, vocab)
    return {"src": src, "src@SEQLEN": lens, "tgt": tgt_in,
            "tgt@SEQLEN": lens, "nxt": tgt_next, "nxt@SEQLEN": lens}


def _seq_vars(P):
    return [P.layers.data(n, [1], dtype="int64", lod_level=1)
            for n in ("src", "tgt", "nxt")]


def test_machine_translation_attention():
    vocab = 24

    def build(P):
        src_v, tgt_v, nxt_v = _seq_vars(P)
        cost = P.models.seq2seq.seq2seq_attention_cost(
            src_v, tgt_v, nxt_v, vocab, vocab, emb_dim=24, hid_dim=24)
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost

    cost = _same_program_as_reference(build)
    first, last = _train(cost, _translation_feed(vocab, 16, 6), 150)
    assert last < first * 0.5, (first, last)


def test_rnn_encoder_decoder():
    """Plain seq2seq: the encoder's last state (sequence_last_step)
    starts the decoder GRU (h_0); squeeze, sequence_mask and the
    operator sugar build the masked loss."""
    vocab, hid = 16, 24

    def build(P):
        L = P.layers
        src_v, tgt_v, nxt_v = _seq_vars(P)
        enc = P.models.seq2seq.encoder(src_v, vocab, emb_dim=16,
                                       hid_dim=hid, bidirectional=False)
        enc_last = L.sequence_last_step(enc)
        tgt_emb = L.embedding(input=tgt_v, size=[vocab, 16])
        dec_proj = L.fc(input=tgt_emb, size=hid * 3)
        dec = L.dynamic_gru(input=dec_proj, size=hid, h_0=enc_last)
        probs = L.fc(input=dec, size=vocab, act="softmax",
                     num_flatten_dims=2)
        token_cost = L.squeeze(L.cross_entropy(input=probs, label=nxt_v),
                               axes=[2])
        mask = L.sequence_mask(tgt_v)
        cost = L.reduce_sum(token_cost * mask) / L.reduce_sum(mask)
        P.AdamOptimizer(learning_rate=1e-2).minimize(cost)
        return cost

    cost = _same_program_as_reference(build)
    first, last = _train(cost, _translation_feed(vocab, 12, 5), 150)
    assert last < first * 0.6, (first, last)


def test_data_layer_lod_levels_match_the_reference():
    """lod_level 0, 1 and 2: the var, its shape and its companions."""
    def build(P):
        P.layers.data("dense", [3])
        a = P.layers.data("seq", [5], lod_level=1)
        b = P.layers.data("nested", [1], dtype="int64", lod_level=2)
        return a, b

    a, b = _same_program_as_reference(build)
    blk = pt.default_main_program().global_block()
    assert a.shape == (-1, -1, 5) and a.seq_len_var == "seq@SEQLEN"
    assert blk.var("seq@SEQLEN").dtype == "int32"
    assert b.shape == (-1, -1, -1, 1)
    assert (b.seq_len_var, b.sub_seq_len_var) == ("nested@SEQLEN",
                                                  "nested@SEQLEN@SUB")
    assert blk.var("nested@SEQLEN@SUB").shape == (-1, -1)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_decode_program_saved_by_one_package_loads_in_the_other(saver,
                                                                tmp_path):
    """seq2seq_attention_infer (beam 3, max_len 5) over one set of
    weights: saved with save_inference_model by `saver`, loaded by the
    other package, both decode the same ragged sources to the same ids
    and lengths (scores within 1e-5)."""
    V, E, H = 12, 8, 8

    def build(P):
        src = P.layers.data("src", [1], dtype="int64", lod_level=1)
        return src, P.models.seq2seq.seq2seq_attention_infer(
            src, V, V, emb_dim=E, hid_dim=H, beam_size=3, max_len=5)

    jpt.framework.reset_default_programs()
    jsrc, jouts = build(jpt)
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    jexe.run(jpt.default_startup_program(), scope=jscope)
    pt.framework.reset_default_programs()
    psrc, pouts = build(pt)
    pexe = pt.Executor(pt.CPUPlace())
    pscope = scope_from_numpy({k: np.array(jscope.get(k))
                               for k in jscope.keys()
                               if not k.startswith("__")}, "cpu")
    d = str(tmp_path / "m")
    if saver == "port":
        pt.io.save_inference_model(d, ["src"], list(pouts), pexe,
                                   scope=pscope)
        prog, feeds, fetch = jpt.io.load_inference_model(
            d, jexe, scope=(ls := jpt.Scope()))
        runner = (jexe, ls)
    else:
        jpt.io.save_inference_model(d, ["src"], list(jouts), jexe,
                                    scope=jscope)
        prog, feeds, fetch = pt.io.load_inference_model(
            d, pexe, scope=(ls := pt.Scope()))
        runner = (pexe, ls)
    assert "src@SEQLEN" in prog.global_block().vars
    rng = np.random.RandomState(5)
    src, lens = _seq_batch(rng, 4, 6, V)
    feed = {"src": src, "src@SEQLEN": lens}
    got = runner[0].run(prog, feed=feed, fetch_list=fetch, scope=runner[1])
    if saver == "port":
        want = pexe.run(pt.default_main_program(), feed=feed,
                        fetch_list=list(pouts), scope=pscope)
    else:
        want = jexe.run(jpt.default_main_program(), feed=feed,
                        fetch_list=list(jouts), scope=jscope)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
