"""The LM server's device functions: JAX reference vs the port.

Same numpy inputs (weights from `init_lm_weights`, tokens, positions,
page tables) go through `paddle_tpu.ops.transformer_ops` and
`paddle_tpu_torch.ops.transformer_ops`. Greedy tokens must be equal;
KV planes allclose at 1e-5 (float32, different summation order in the
attention and the matmuls). The paged pool's page 0 is the trash page:
both sides write bucket padding there in an unspecified order, so it is
left out of the comparison.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import transformer_ops as JT
from paddle_tpu.serving.lm import LMSpec, init_lm_weights
from paddle_tpu_torch.ops import transformer_ops as PT

TOL = 1e-5
SPEC = LMSpec(vocab_size=31, hidden_size=16, num_layers=2, num_heads=2,
              max_len=32)
W = init_lm_weights(SPEC, seed=3)
N, L, H = SPEC.num_heads, SPEC.num_layers, SPEC.hidden_size
D = H // N


def _head(lib):
    if lib is JT:
        w = {k: jnp.asarray(v) for k, v in W.items()}
    else:
        w = {k: torch.from_numpy(v) for k, v in W.items()}
    return (tuple(w[f"stack.{leaf}"] for leaf in JT._LEAVES), w["tok_emb"],
            w["pos_emb"], w["ln_f.w_0"], w["ln_f.w_1"], w["lm_head.w"], N)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plane(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port_plane, jax_plane, skip_trash=False):
    a, b = port_plane.numpy(), np.asarray(jax_plane)
    if skip_trash:
        a, b = a[:, 1:], b[:, 1:]
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_slot_prefill_and_decode_match():
    S, Tcap = 3, 14
    ck0, cv0 = _plane((L, S, N, Tcap, D), 0), _plane((L, S, N, Tcap, D), 1)
    toks = np.array([[3, 7, 11, 2, 5, 0, 0, 0], [1, 4, 0, 0, 0, 0, 0, 0]],
                    np.int32)
    plen = np.array([5, 2], np.int32)
    slots = np.array([2, S], np.int32)         # second row is padding
    jtok, jck, jcv = JT.slot_prefill(*_head(JT), *_j(ck0, cv0, toks, plen,
                                                     slots))
    ck, cv = _t(ck0, cv0)
    ptok = PT.slot_prefill(*_head(PT), ck, cv, *_t(toks, plen, slots))
    assert ptok.numpy().tolist() == np.asarray(jtok).tolist()
    _close(ck, jck)
    _close(cv, jcv)

    tok = np.array([4, 9, int(ptok[0])], np.int32)
    pos_idx = np.array([0, 3, 5], np.int32)
    live = np.array([False, True, True])
    jnxt, jck, jcv = JT.slot_decode_step(*_head(JT), *_j(
        np.asarray(jck), np.asarray(jcv), tok, pos_idx, live))
    pnxt = PT.slot_decode_step(*_head(PT), ck, cv, *_t(tok, pos_idx, live))
    assert pnxt.numpy().tolist() == np.asarray(jnxt).tolist()
    assert pnxt[0] == 0                        # dead slot forced to 0
    _close(ck, jck)
    _close(cv, jcv)


def _paged_state(P=6, pl=4):
    return _plane((L, P, N, pl, D), 10), _plane((L, P, N, pl, D), 11)


@pytest.mark.parametrize("start", [0, 4])
def test_paged_prefill_matches(start):
    """Cold prefill (start 0), then a prefix hit resuming at start > 0
    over pages a cold prefill filled."""
    ck0, cv0 = _paged_state()
    m = 4
    prompt = np.array([3, 7, 11, 2, 5, 9, 1], np.int32)
    # first, a cold prefill of the prompt into pages 1, 2
    toks = np.zeros((2, 8), np.int32)
    toks[0, :7] = prompt
    tables = np.zeros((2, m), np.int32)
    tables[0, :2] = [1, 2]
    start0, plen0 = np.zeros(2, np.int32), np.array([7, 1], np.int32)
    jtok, jck, jcv = JT.paged_prefill(*_head(JT), *_j(
        ck0, cv0, toks, start0, plen0, tables))
    ck, cv = _t(ck0, cv0)
    ptok = PT.paged_prefill(*_head(PT), ck, cv,
                            *_t(toks, start0, plen0, tables))
    assert ptok[0] == int(jtok[0])
    _close(ck, jck, skip_trash=True)
    _close(cv, jcv, skip_trash=True)
    if not start:
        return
    # a second prompt shares the first page (4 tokens): its suffix
    # prefills from position `start` into its own pages 3, 4
    second = np.concatenate([prompt[:4], [8, 8, 6, 2, 2]]).astype(np.int32)
    toks = np.zeros((2, 8), np.int32)
    toks[0, :5] = second[start:]
    tables = np.zeros((2, m), np.int32)
    tables[0, :3] = [1, 3, 4]
    starts = np.array([start, 0], np.int32)
    plen = np.array([9, 1], np.int32)
    jtok, jck, jcv = JT.paged_prefill(*_head(JT), *_j(
        np.asarray(jck), np.asarray(jcv), toks, starts, plen, tables))
    ptok = PT.paged_prefill(*_head(PT), ck, cv, *_t(toks, starts, plen,
                                                    tables))
    assert ptok[0] == int(jtok[0])
    _close(ck, jck, skip_trash=True)
    _close(cv, jcv, skip_trash=True)


def test_paged_decode_step_and_page_copy_match():
    ck0, cv0 = _paged_state()
    tables = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [3, 4, 5, 0]], np.int32)
    tok = np.array([5, 0, 17], np.int32)
    pos_idx = np.array([6, 0, 9], np.int32)
    live = np.array([True, False, True])
    jnxt, jck, jcv = JT.paged_decode_step(*_head(JT), *_j(
        ck0, cv0, tok, pos_idx, live, tables))
    ck, cv = _t(ck0, cv0)
    pnxt = PT.paged_decode_step(*_head(PT), ck, cv,
                                *_t(tok, pos_idx, live, tables))
    assert pnxt.numpy().tolist() == np.asarray(jnxt).tolist()
    _close(ck, jck, skip_trash=True)
    _close(cv, jcv, skip_trash=True)

    jck, jcv = JT.page_copy(jck, jcv, jnp.int32(2), jnp.int32(5))
    PT.page_copy(ck, cv, 2, 5)
    _close(ck, jck, skip_trash=True)
    _close(cv, jcv, skip_trash=True)
    np.testing.assert_array_equal(ck[:, 5].numpy(), ck[:, 2].numpy())


def test_ln_f32_matches_reference_on_offset_rows():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, H) * 4 + 100).astype(np.float32)  # |mean| >> std
    g, b = rng.randn(H).astype(np.float32), rng.randn(H).astype(np.float32)
    np.testing.assert_allclose(
        PT._ln_f32(*_t(x, g, b)).numpy(),
        np.asarray(JT._ln_f32(*_j(x, g, b))), rtol=TOL, atol=TOL)
