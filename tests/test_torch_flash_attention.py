"""K1 flash-attention forward: the port's plain version against the JAX
Pallas kernel run in interpret mode, the query-offset extension against
a naive masked softmax, and the wrapper's CPU routing and validation.

The Hopper kernel itself (csrc/flash_attn_fwd.cu) has no interpret
mode: tests/test_torch_cuda_kernels.py holds it to this plain version on
the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_attention as pal
from paddle_tpu_torch.ops import flash_attention as fa

TOL = 2e-5   # the JAX suite's own flash tolerance (test_pallas_attention)


def _qkv(B, n, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, Tq, D).astype(np.float32),
            rng.randn(B, n, Tk, D).astype(np.float32),
            rng.randn(B, n, Tk, D).astype(np.float32))


def _port(q, k, v, kv_len, q_start, causal):
    o, lse = fa.flash_attn_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(kv_len, dtype=torch.int32),
        torch.tensor(q_start, dtype=torch.int32), causal=causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,D,kv_len", [
    (2, 2, 32, 32, 16, [32, 32]),            # square, full length
    (3, 2, 16, 48, 16, [48, 17, 0]),         # Tq != Tk, ragged + empty
    (2, 3, 40, 24, 64, [24, 9]),             # Tq > Tk, D = 64
    (1, 2, 8, 64, 64, [0]),                  # every row fully masked
    # the Hopper kernel's 64-row query and 64-key tiles at their edges
    (2, 1, 63, 63, 16, [63, 62]),            # one row short of a tile
    (2, 1, 64, 64, 16, [64, 63]),            # exactly one tile
    (2, 1, 65, 65, 16, [65, 64]),            # one row into a second tile
    (3, 1, 65, 130, 32, [129, 65, 63]),      # kv_len either side of 64, 128
    (2, 1, 130, 65, 16, [65, 64]),           # Tq > Tk across tiles
])
def test_plain_matches_jax_k1_interpret(causal, B, n, Tq, Tk, D, kv_len):
    q, k, v = _qkv(B, n, Tq, Tk, D, seed=Tq + Tk)
    ref_o, ref_lse = pal.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=jnp.asarray(kv_len, jnp.int32), block_q=8, block_k=8,
        interpret=True)
    o, lse = _port(q, k, v, kv_len, [0] * B, causal)
    np.testing.assert_allclose(o, np.asarray(ref_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)
    for b, n_live in enumerate(kv_len):
        if n_live == 0:   # fully masked rows: O = 0, LSE = -1e30 (K1)
            assert np.abs(o[b]).max() == 0.0
            assert np.all(lse[b] == np.float32(fa.NEG))


def _naive(q, k, v, kv_len, q_start):
    """Causal masked softmax with a per-batch query offset, in f64."""
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    o = np.zeros((B, n, Tq, D))
    lse = np.full((B, n, Tq), fa.NEG)
    for b in range(B):
        for r in range(Tq):
            lim = min(kv_len[b], q_start[b] + r + 1, Tk)
            if lim <= 0:
                continue
            s = np.einsum("nd,ntd->nt", q[b, :, r].astype(np.float64),
                          k[b, :, :lim]) / np.sqrt(D)
            m = s.max(-1, keepdims=True)
            p = np.exp(s - m)
            o[b, :, r] = np.einsum("nt,ntd->nd", p / p.sum(-1, keepdims=True),
                                   v[b, :, :lim])
            lse[b, :, r] = (m + np.log(p.sum(-1, keepdims=True)))[:, 0]
    return o, lse


@pytest.mark.parametrize("Tq,Tk,kv_len,q_start", [
    (8, 40, [40, 21, 13], [16, 8, 5]),       # prefix-hit prefill rows
    (1, 33, [33, 1, 7], [32, 0, 6]),         # decode: Tq = 1, pos = len-1
    (6, 24, [10, 24, 3], [4, 30, 0]),        # kv_len caps the diagonal
    # prefix-hit rows whose causal limit crosses a 64-key tile
    (65, 140, [140, 129, 64], [75, 64, 0]),
])
def test_query_offset_matches_naive_softmax(Tq, Tk, kv_len, q_start):
    q, k, v = _qkv(3, 2, Tq, Tk, 16, seed=Tq * Tk)
    o, lse = _port(q, k, v, kv_len, q_start, causal=True)
    ref_o, ref_lse = _naive(q, k, v, kv_len, q_start)
    np.testing.assert_allclose(o, ref_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, ref_lse, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = _qkv(2, 2, 4, 8, 16, seed=1)
    before = fa.flash_attn_fwd.launches
    o, lse = _port(q, k, v, [8, 5], [4, 1], causal=True)
    assert fa.flash_attn_fwd.launches == before
    assert o.shape == (2, 2, 4, 16) and lse.shape == (2, 2, 4)


def test_wrapper_rejects_mismatched_operands():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 4, 8, 16, seed=2))
    lens = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attn_fwd(q, k, v, lens[:1], lens)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attn_fwd(q, k[:, :, :, :8], v, lens, lens)
    with pytest.raises(ValueError, match="B, n, T, D"):
        fa.flash_attn_fwd(q[0], k, v, lens, lens)
