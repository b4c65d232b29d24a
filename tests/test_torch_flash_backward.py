"""Flash-attention backward (K2-K4) and the lm-head log-sum-exp (K5):
the port's plain versions against the JAX package's Pallas kernels run
in interpret mode (K5 also as the f32 kernel's split and merge), the
backward route rule, the training op's autograd Function, and the
wrappers' CPU and meta routing.

The Hopper kernels themselves (csrc/flash_attn_bwd.cu,
csrc/lm_head_lse.cu) have no interpret mode:
tests/test_torch_cuda_kernels.py holds them to these plain versions on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import chunked_ce as jce
from paddle_tpu.ops import pallas_attention as pal
from paddle_tpu_torch.ops import chunked_ce as ce
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.registry import get_op

TOL = 2e-5   # the JAX suite's own flash tolerance (test_pallas_attention)


def _inputs(B, n, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) for s in
                 ((B, n, Tq, D), (B, n, Tk, D), (B, n, Tk, D),
                  (B, n, Tq, D)))


def _reference_grads(q, k, v, do, kv_len, causal, plane=False):
    """jax.grad of the Pallas flash attention (interpret mode, 8 x 8
    blocks) against the cotangent do."""
    lens = jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        if plane:
            B, n, Tq, D = do.shape
            to = lambda x: jnp.transpose(x, (0, 2, 1, 3)).reshape(  # noqa
                x.shape[0], x.shape[2], n * D)
            out = pal.flash_attention_plane(
                to(q), to(k), to(v), n, causal=causal, kv_len=lens,
                block_q=8, block_k=8, interpret=True)
            return jnp.sum(out * to(jnp.asarray(do)))
        out = pal.flash_attention(q, k, v, causal=causal, kv_len=lens,
                                  block_q=8, block_k=8, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _bwd_by_route(route, q, k, v, o, lse, do, lens, causal):
    """The backward through one named route, as the kernel checks call
    it: delta = rowsum(dO * O), then K2, or K3 and K4."""
    delta = (do * o).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, lens, causal)
    if route == "fused":
        return fa.flash_attn_bwd_fused(*args)
    return (fa.flash_attn_bwd_dq(*args), *fa.flash_attn_bwd_dkv(*args))


# T = 16 is nk = 2 (the reference's fused K2), T = 48 is nk = 6 (its
# split K3 + K4) at the reference's 8-key blocks
CASES = [
    # B, n, Tq, Tk, D, kv_len
    (2, 2, 16, 16, 16, [16, 16]),
    (2, 2, 48, 48, 16, [48, 48]),
    (3, 2, 48, 48, 16, [48, 17, 0]),      # ragged, one batch fully masked
    (2, 2, 16, 48, 16, [48, 30]),         # Tq != Tk (cross attention)
    (2, 1, 40, 24, 32, [24, 9]),          # Tq > Tk
    # the Hopper kernels' 64-row / 64-key tiles at their edges
    (2, 1, 63, 63, 16, [63, 62]),         # one short of a tile
    (2, 1, 64, 64, 16, [64, 63]),         # exactly one tile
    (2, 1, 65, 65, 16, [65, 64]),         # one into a second tile
    (2, 1, 65, 129, 16, [129, 65]),       # kv_len either side of 64, 128
    (2, 1, 70, 33, 16, [33, 32]),         # Tq > Tk across tiles
    # the edges of 128-row / 128-key blocks
    (2, 1, 127, 127, 16, [127, 126]),     # one short of two tiles
    (2, 1, 128, 128, 16, [128, 127]),     # exactly two tiles
    (2, 1, 129, 129, 16, [129, 128]),     # one into a third tile
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,D,kv_len", CASES)
def test_plain_backward_matches_jax_pallas_interpret(causal, B, n, Tq, Tk,
                                                     D, kv_len):
    q, k, v, do = _inputs(B, n, Tq, Tk, D, seed=Tq * 7 + Tk)
    ref = _reference_grads(q, k, v, do, kv_len, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lens = torch.tensor(kv_len, dtype=torch.int32)
    o, lse = fa.flash_attn_fwd(tq, tk, tv, lens, torch.zeros_like(lens),
                               causal)
    before = (fa.flash_attn_bwd_fused.launches,
              fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches)
    for route in ("fused", "split"):
        got = _bwd_by_route(route, tq, tk, tv, o, lse, tdo, lens, causal)
        for name, g, r in zip("qkv", got, ref):
            np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL,
                                       err_msg=f"d{name} ({route})")
    # CPU tensors take the plain versions: no kernel was launched
    assert (fa.flash_attn_bwd_fused.launches, fa.flash_attn_bwd_dq.launches,
            fa.flash_attn_bwd_dkv.launches) == before


def test_k2_and_the_split_pair_agree_on_the_cpu():
    """The fused route's dq equals the split route's (the same function;
    the kernels sum it in different orders)."""
    q, k, v, do = _inputs(2, 3, 70, 70, 64, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    lens = torch.tensor([70, 41], dtype=torch.int32)
    o, lse = fa.flash_attn_fwd(t[0], t[1], t[2], lens,
                               torch.zeros_like(lens), True)
    fused = _bwd_by_route("fused", t[0], t[1], t[2], o, lse, t[3], lens,
                          True)
    split = _bwd_by_route("split", t[0], t[1], t[2], o, lse, t[3], lens,
                          True)
    for a, b in zip(fused, split):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("Tk,route", [(16, "fused"), (256, "fused"),
                                      (257, "split"), (1024, "split")])
def test_backward_route_rule(Tk, route):
    """nk <= 4 of the port's 64-key tiles takes K2 (the reference's rule
    on its own blocks); the GPT-2 training length takes K3 + K4."""
    assert fa.bwd_route(Tk) == route


@pytest.mark.parametrize("causal", [False, True])
def test_attention_op_function_matches_jax_plane_gradients(causal):
    """The training op's autograd Function over packed [B, T, n*D]
    planes (K1 forward, the routed backward), fed strided q/k/v slices
    of one qkv plane as the attention op is, against jax.grad of the
    reference's plane flash attention."""
    B, n, T, D = 2, 2, 24, 16
    q, k, v, do = _inputs(B, n, T, T, D, seed=11)
    kv_len = [24, 13]
    ref = _reference_grads(q, k, v, do, kv_len, causal, plane=True)
    plane = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3).reshape(  # noqa
        B, T, n * D)
    qkv = torch.cat([plane(q), plane(k), plane(v)], dim=2).requires_grad_()
    H = n * D
    out = fa.flash_attention_plane(qkv[..., :H], qkv[..., H:2 * H],
                                   qkv[..., 2 * H:], n, causal=causal,
                                   kv_len=torch.tensor(kv_len))
    out.backward(plane(do))
    g = qkv.grad
    for i, (name, r) in enumerate(zip("qkv", ref)):
        got = g[..., i * H:(i + 1) * H].reshape(B, T, n, D).permute(
            0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), r, rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


def test_backward_wrappers_give_shapes_on_meta_tensors():
    q = torch.empty(2, 3, 40, 64, device="meta")
    k = torch.empty(2, 3, 56, 64, device="meta")
    lse = torch.empty(2, 3, 40, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    dq = fa.flash_attn_bwd_dq(q, k, k, q, lse, lse, lens)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, k, q, lse, lse, lens)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    x = torch.empty(5, 32, device="meta")
    assert ce.lm_head_lse(x, torch.empty(32, 70, device="meta")).shape \
        == (5,)


@pytest.mark.parametrize("N,H,V", [(20, 32, 200), (64, 64, 96),
                                   (9, 48, 1000)])
def test_plain_lse_matches_jax_pallas_lse_interpret(N, H, V):
    """K5's plain version against the reference's Pallas lse in
    interpret mode (8-row, 64-column blocks; V not a multiple of 64).
    Tolerance 1e-5, not bitwise: the reference's own bitwise test of
    this kernel fails on jax 0.9 (ROADMAP, queue C)."""
    rng = np.random.RandomState(N + V)
    x = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.3).astype(np.float32)
    ref = np.asarray(jce.pallas_lse(jnp.asarray(x), jnp.asarray(w), bn=8,
                                    bv=64, interpret=True))
    before = ce.lm_head_lse.launches
    got = ce.lm_head_lse(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert ce.lm_head_lse.launches == before      # CPU: the plain version
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the plain version's chunking does not change the function
    np.testing.assert_allclose(
        ce.lm_head_lse_plain(torch.from_numpy(x), torch.from_numpy(w),
                             chunk=64).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,H,V,splits", [(20, 32, 200, 3),
                                          (9, 48, 1000, 7),
                                          (64, 64, 96, 5),
                                          (33, 32, 131, 2)])
def test_plain_lse_split_merge_matches_jax_pallas_lse_interpret(N, H, V,
                                                                splits):
    """The f32 K5's split and merge as plain arithmetic (each vocab range
    of ceil(V / splits) columns reduced to a (max, denominator) per row,
    the ranges merged in order) against the reference's Pallas lse in
    interpret mode, with V not a multiple of the split width or of the
    reference's 64-column blocks. Tolerance 1e-5, as the unsplit plain
    version's."""
    assert V % -(-V // splits)                   # a ragged last range
    rng = np.random.RandomState(N * V + splits)
    x = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.3).astype(np.float32)
    ref = np.asarray(jce.pallas_lse(jnp.asarray(x), jnp.asarray(w), bn=8,
                                    bv=64, interpret=True))
    got = ce.lm_head_lse_plain(torch.from_numpy(x), torch.from_numpy(w),
                               chunk=16, splits=splits).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_lse_splits_fill_the_card_and_stay_in_range():
    """The f32 K5's split count: at the training shape (N 8192 in 64
    row blocks of 128, V 50304 in 393 tiles of 128) ~16 blocks for each
    of an H100's 132 SMs; never more splits than vocab tiles, never
    fewer than one."""
    assert ce.lse_splits(8192, 50304, 132) == 33
    assert 64 * 33 >= 16 * 132
    assert ce.lse_splits(5, 70, 132) == 1        # one vocab tile
    assert ce.lse_splits(10**6, 50304, 132) == 1  # rows alone fill it
    assert ce.lse_splits(300, 5000, 132) == 40   # at most one a tile
    assert ce.LSE_ROWS == ce.LSE_COLS == 128


def test_chunked_xent_matches_jax_values_and_gradients():
    """The fused lm-head cross-entropy (K5's plain lse forward, the
    chunked backward) against the reference's chunked_lm_head_xent,
    values and gradients, with a ragged last vocab chunk."""
    N, H, V, C = 24, 32, 250, 3
    rng = np.random.RandomState(5)
    x = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.2).astype(np.float32)
    lab = rng.randint(0, V, N)
    g = rng.rand(N).astype(np.float32)

    def f(x, w):
        return jnp.sum(jce.chunked_lm_head_xent(x, w, jnp.asarray(lab), C)
                       * g)
    ref_loss = np.asarray(jce.chunked_lm_head_xent(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab), C))
    ref_dx, ref_dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = ce.chunked_lm_head_xent(tx, tw, torch.from_numpy(lab), C)
    (loss * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_dw),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("C", [1, 3])
def test_cached_logits_xent_matches_jax_cached_path(C, monkeypatch):
    """cache_logits=True: the chunk logits kept from the forward feed the
    backward, and K5 does not run (its wrapper is made to raise); loss
    and gradients against the reference's cached chunked_lm_head_xent,
    at the uncached test's tolerances."""
    N, H, V = 24, 32, 250
    rng = np.random.RandomState(7)
    x = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.2).astype(np.float32)
    lab = rng.randint(0, V, N)
    g = rng.rand(N).astype(np.float32)

    def f(x, w):
        return jnp.sum(jce.chunked_lm_head_xent(
            x, w, jnp.asarray(lab), C, cache=True) * g)
    ref_loss = np.asarray(jce.chunked_lm_head_xent(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab), C, cache=True))
    ref_dx, ref_dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w))

    def no_k5(*a):
        raise AssertionError("K5 ran with cache_logits")
    monkeypatch.setattr(ce, "lm_head_lse", no_k5)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = get_op("fused_lm_head_xent").lowering(
        None, {"X": [tx[None]], "W": [tw],
               "Label": [torch.from_numpy(lab)[None, :, None]]},
        {"num_chunks": C, "cache_logits": True})["Loss"][0]
    loss = out.reshape(N)
    (loss * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_dw),
                               rtol=1e-5, atol=1e-6)
