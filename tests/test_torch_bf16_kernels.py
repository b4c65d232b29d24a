"""The bf16 (amp) paths of K1, K2, K3 + K4 and K5, and the head-dim
padding of the card's wrappers, on the CPU.

Each bf16 plain version (the function its Hopper kernel is held to on
the card) against the JAX package's Pallas kernel run in interpret mode
with bf16 inputs: K1 forward, the fused backward K2 (16- or 32-key
blocks, so the reference takes its fused route) and K2's sum-and-cast of
its f32 dq partials, the split backward K3 + K4 (Tk 64 in 8-key blocks,
so the reference takes its split route), K5 unsplit and in the vocab
splits its kernel merges in order (with the split count's rule). And the
padded-D route the CUDA wrappers take for a head dim below the kernels'
(the reference's `_pad_d`), applied to CPU tensors through the same
helpers, against Pallas at D 8, 16 and 48.

Tolerances: bf16 results are compared within 1e-2 of the largest
|reference| element, two bf16 ulps (2^-8 relative each): both sides sum
f32 products of the same bf16 operands, in other orders, and round once
to bf16. f32 results (the LSE, the padded f32 path) at the JAX suite's
flash tolerance 2e-5.
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

BF16_REL = 1e-2
TOL = 2e-5


def _bf16_inputs(shapes, seed):
    """Random tensors whose values are exact in bf16, as numpy f32 (the
    JAX side casts them to bf16 without rounding)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32))
            .bfloat16().float().numpy() for s in shapes]


def _close(got, ref, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got - ref).max())
    assert err <= BF16_REL * float(np.abs(ref).max()), (what, err)


def _bf(x):
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,kv_len", [
    (2, 2, 64, 64, [64, 64]),
    (3, 2, 40, 72, [72, 33, 0]),      # Tq != Tk, ragged, one batch empty
    (2, 1, 65, 65, [65, 64]),         # a 64-row / 64-key tile edge
])
def test_k1_bf16_plain_matches_pallas_interpret(causal, B, n, Tq, Tk,
                                                kv_len):
    q, k, v = _bf16_inputs([(B, n, Tq, 64), (B, n, Tk, 64),
                            (B, n, Tk, 64)], seed=Tq + Tk)
    ref_o, ref_lse = pal.flash_attention_with_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        kv_len=jnp.asarray(kv_len, jnp.int32), block_q=8, block_k=8,
        interpret=True)
    assert ref_o.dtype == jnp.bfloat16
    lens = torch.tensor(kv_len, dtype=torch.int32)
    before = fa.flash_attn_fwd_bf16.launches
    o, lse = fa.flash_attn_fwd_bf16(_bf(q), _bf(k), _bf(v), lens,
                                    torch.zeros_like(lens), causal)
    assert fa.flash_attn_fwd_bf16.launches == before   # CPU: plain
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(o.float(), np.asarray(ref_o, np.float32), "O")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)


def _pallas_grads(q, k, v, do, kv_len, causal, dtype, D=None, block=8):
    """jax.grad of the Pallas flash attention (interpret mode, block x
    block tiles; the default 8 makes Tk 64 eight kv blocks, the
    reference's split K3 + K4) in `dtype`, against the cotangent do."""
    lens = jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        out = pal.flash_attention(q, k, v, causal=causal, kv_len=lens,
                                  block_q=block, block_k=block,
                                  interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    return [np.asarray(g, np.float32) for g in jax.grad(
        f, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,kv_len", [
    (2, 2, 64, 64, [64, 64]),
    (2, 2, 48, 64, [64, 29]),         # Tq != Tk, ragged
])
def test_k3_k4_bf16_plain_match_pallas_split_interpret(causal, B, n, Tq,
                                                       Tk, kv_len):
    q, k, v, do = _bf16_inputs([(B, n, Tq, 64), (B, n, Tk, 64),
                                (B, n, Tk, 64), (B, n, Tq, 64)],
                               seed=Tq * 3 + Tk)
    ref = _pallas_grads(q, k, v, do, kv_len, causal, jnp.bfloat16)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    tq, tk, tv, tdo = map(_bf, (q, k, v, do))
    o, lse = fa.flash_attn_fwd(tq, tk, tv, lens, torch.zeros_like(lens),
                               causal)
    delta = (tdo.float() * o.float()).sum(-1).contiguous()
    before = (fa.flash_attn_bwd_dq_bf16.launches,
              fa.flash_attn_bwd_dkv_bf16.launches)
    dq = fa.flash_attn_bwd_dq_bf16(tq, tk, tv, tdo, lse, delta, lens,
                                   causal)
    dk, dv = fa.flash_attn_bwd_dkv_bf16(tq, tk, tv, tdo, lse, delta, lens,
                                        causal)
    assert (fa.flash_attn_bwd_dq_bf16.launches,
            fa.flash_attn_bwd_dkv_bf16.launches) == before
    for name, g, r in zip("qkv", (dq, dk, dv), ref):
        assert g.dtype == torch.bfloat16
        _close(g.float(), r, f"d{name}")
    # the route function takes the same path for bf16 at Tk > 256 on the
    # card; on the CPU every route is the plain function
    got = fa.flash_attn_bwd(tq, tk, tv, o, lse, tdo, lens, causal)
    for name, g, r in zip("qkv", got, ref):
        _close(g.float(), r, f"d{name} (route)")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,kv_len,block", [
    (2, 2, 64, 64, [64, 64], 16),       # nk = 4
    (3, 2, 48, 64, [64, 29, 0], 16),    # Tq != Tk, ragged, one batch empty
    (2, 1, 96, 60, [60, 37], 32),       # Tq > Tk, Tk padded to 64, nk = 2
])
def test_k2_bf16_plain_matches_pallas_fused_interpret(monkeypatch, causal, B,
                                                      n, Tq, Tk, kv_len,
                                                      block):
    """K2-bf16's plain version (the function the card's fused kernel is
    held to) against the Pallas single-sweep `_bwd_fused_kernel` with
    bf16 inputs: blocks of 16 or 32 keep the reference's kv block count
    nk <= 4, so it takes its fused route (f32 dq partials per kv block,
    summed, cast once to bf16)."""
    fused_calls = []
    fused = pal._bwd_fused_kernel

    def spy(*args, **kwargs):
        fused_calls.append(kwargs["block_k"])
        return fused(*args, **kwargs)

    monkeypatch.setattr(pal, "_bwd_fused_kernel", spy)
    q, k, v, do = _bf16_inputs([(B, n, Tq, 64), (B, n, Tk, 64),
                                (B, n, Tk, 64), (B, n, Tq, 64)],
                               seed=Tq * 5 + Tk)
    ref = _pallas_grads(q, k, v, do, kv_len, causal, jnp.bfloat16,
                        block=block)
    assert fused_calls and set(fused_calls) == {block}
    lens = torch.tensor(kv_len, dtype=torch.int32)
    tq, tk, tv, tdo = map(_bf, (q, k, v, do))
    o, lse = fa.flash_attn_fwd(tq, tk, tv, lens, torch.zeros_like(lens),
                               causal)
    delta = (tdo.float() * o.float()).sum(-1).contiguous()
    before = (fa.flash_attn_bwd_fused.launches,
              fa.flash_attn_bwd_fused_bf16.launches)
    got = fa.flash_attn_bwd_fused_bf16(tq, tk, tv, tdo, lse, delta, lens,
                                       causal)
    assert (fa.flash_attn_bwd_fused.launches,
            fa.flash_attn_bwd_fused_bf16.launches) == before   # CPU: plain
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16
        _close(g.float(), r, f"d{name}")
    # Tk <= 256: the route function takes the same (fused) function
    assert fa.bwd_route(Tk) == "fused"
    for name, g, r in zip("qkv", fa.flash_attn_bwd(tq, tk, tv, o, lse, tdo,
                                                   lens, causal), ref):
        _close(g.float(), r, f"d{name} (route)")


@pytest.mark.parametrize("nk", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_dq_partials_sums_in_order_and_casts_once(nk, dtype):
    """K2's dq from its f32 partials [nk, B, Tq, n, D]: the left-to-right
    sum over the kv tiles, bitwise, cast once to the operands' dtype (not
    a sum of rounded partials), as the [B, n, Tq, D] view of a plane;
    within f32 rounding of the reference's jnp.sum(dq_part, 0)."""
    rng = np.random.RandomState(nk)
    # magnitudes 1e-3 .. 1e3 across the tiles, so the order of the sum
    # shows in the f32 result
    mag = 10.0 ** rng.randint(-3, 4, (nk, 1, 1, 1, 1))
    part_np = (rng.randn(nk, 2, 5, 3, 64) * mag).astype(np.float32)
    part = torch.from_numpy(part_np)
    dq = fa.sum_dq_partials(part, dtype)
    assert dq.dtype == dtype and dq.shape == (2, 3, 5, 64)
    assert dq.permute(0, 2, 1, 3).is_contiguous()
    want = part[0].clone()
    for j in range(1, nk):
        want = want + part[j]
    assert torch.equal(dq, want.to(dtype).permute(0, 2, 1, 3))
    ref = np.asarray(jnp.sum(jnp.asarray(part_np), axis=0)
                     .astype(jnp.bfloat16 if dtype == torch.bfloat16
                             else jnp.float32), np.float32)
    np.testing.assert_allclose(
        dq.float().permute(0, 2, 1, 3).numpy(), ref,
        rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
        atol=1e-2 if dtype == torch.bfloat16 else 1e-6)


def test_bf16_wrappers_refuse_other_dtypes():
    q = torch.zeros(1, 1, 4, 64)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attn_fwd_bf16(q, q, q, lens, lens)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attn_bwd_dq_bf16(q, q, q, q, q[..., 0], q[..., 0], lens)
    with pytest.raises(TypeError, match="bfloat16"):
        ce.lm_head_lse_bf16(torch.zeros(4, 8), torch.zeros(8, 16))


@pytest.mark.parametrize("N,H,V", [(20, 32, 200), (64, 64, 96),
                                   (9, 48, 1000)])
def test_k5_bf16_plain_matches_pallas_lse_interpret(N, H, V):
    """K5 with bf16 x and w: f32 dot products of bf16 operands, then an
    f32 log-sum-exp; both sides give f32."""
    x, = _bf16_inputs([(N, H)], seed=N)
    w, = _bf16_inputs([(H, V)], seed=V)
    w = (torch.from_numpy(w) * 0.25).bfloat16()   # a power of 2: exact
    ref = np.asarray(jce.pallas_lse(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w.float().numpy(),
                                                jnp.bfloat16),
                                    bn=8, bv=64, interpret=True))
    before = ce.lm_head_lse_bf16.launches
    got = ce.lm_head_lse_bf16(_bf(x), w)
    assert ce.lm_head_lse_bf16.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,H,V,splits", [(20, 32, 200, 3),
                                          (9, 48, 1000, 7),
                                          (64, 64, 96, 5),
                                          (33, 32, 525, 2)])
def test_plain_lse_bf16_split_merge_matches_jax_pallas_lse_interpret(
        N, H, V, splits):
    """The bf16 K5's split and merge as plain arithmetic (each vocab
    range of ceil(V / splits) columns reduced to a (max, denominator) per
    row, the ranges merged in order) on bf16 x and w, against the
    reference's Pallas lse in interpret mode on the same bf16 operands,
    with a ragged last range and V not a multiple of the reference's
    64-column blocks. Tolerance 1e-5, as the unsplit version's."""
    assert V % -(-V // splits) and V % 64        # ragged ranges and blocks
    x, = _bf16_inputs([(N, H)], seed=N * splits)
    w, = _bf16_inputs([(H, V)], seed=V + splits)
    w = (torch.from_numpy(w) * 0.25).bfloat16()   # a power of 2: exact
    ref = np.asarray(jce.pallas_lse(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w.float().numpy(),
                                                jnp.bfloat16),
                                    bn=8, bv=64, interpret=True))
    got = ce.lm_head_lse_plain(_bf(x), w, chunk=16, splits=splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_lse_splits_for_the_bf16_tile_fill_the_card_and_stay_in_range():
    """The bf16 K5's split count (units of 128 rows x 256-column
    logits tiles): at the amp B 8 step's N 8192 (64 row blocks, 197
    vocab tiles) 2112 units, 16 for each of an H100's 132 SMs, and at
    B 32's N 32768 at least as many; never more splits than vocab tiles,
    never fewer than one; the f32 K5's answers unchanged."""
    rows, cols = ce.LSE_BF16_ROWS, ce.LSE_BF16_COLS
    assert (rows, cols) == (128, 256)

    def splits(N, V):
        return ce.lse_splits(N, V, 132, rows=rows, cols=cols)
    assert splits(8192, 50304) == 33
    assert 64 * splits(8192, 50304) == 16 * 132
    assert 256 * splits(32768, 50304) >= 16 * 132
    assert splits(300, 1000) == 4                  # at most one a tile
    assert splits(200, 8) == 1                     # V below one tile
    assert splits(1, 50304) == 197
    assert splits(10**6, 50304) == 1               # rows alone fill it
    for N in (1, 129, 8192, 32768):
        for V in (8, 256, 257, 50304):
            k = splits(N, V)
            assert 1 <= k <= -(-V // cols)
    assert ce.lse_splits(8192, 50304, 132) == 33   # the f32 K5's


def test_chunked_xent_bf16_matches_jax_values_and_gradients():
    """The fused lm-head cross-entropy with bf16 x and w (the amp lm
    head): the loss and lse in f32, dx and dw in the operands' dtype,
    against the reference's chunked_lm_head_xent. d = (p - onehot) * g
    is rounded to bf16 before its two products in both."""
    N, H, V, C = 24, 32, 250, 3
    rng = np.random.RandomState(5)
    x, w = _bf16_inputs([(N, H), (H, V)], seed=6)
    w = w * np.float32(0.125)
    lab = rng.randint(0, V, N)
    g = rng.rand(N).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jce.chunked_lm_head_xent(
            x, w, jnp.asarray(lab), C) * jnp.asarray(g))

    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref_loss = np.asarray(jce.chunked_lm_head_xent(jx, jw, jnp.asarray(lab),
                                                   C))
    ref_dx, ref_dw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx, tw = _bf(x).requires_grad_(), _bf(w).requires_grad_()
    loss = ce.chunked_lm_head_xent(tx, tw, torch.from_numpy(lab), C)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-5,
                               atol=1e-5)
    (loss * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _close(tx.grad.float(), np.asarray(ref_dx, np.float32), "dx")
    _close(tw.grad.float(), np.asarray(ref_dw, np.float32), "dw")



def test_cached_logits_xent_bf16_matches_jax_cached_path():
    """cache_logits=True with bf16 x and w: the chunk logits are kept in
    bf16 (the reference's `lg.astype(x.dtype)`) and the backward's
    softmax reads them back; loss and gradients against the reference's
    cached chunked_lm_head_xent, at the uncached bf16 test's
    tolerances."""
    N, H, V, C = 24, 32, 250, 3
    rng = np.random.RandomState(8)
    x, w = _bf16_inputs([(N, H), (H, V)], seed=9)
    w = w * np.float32(0.125)
    lab = rng.randint(0, V, N)
    g = rng.rand(N).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jce.chunked_lm_head_xent(
            x, w, jnp.asarray(lab), C, cache=True) * jnp.asarray(g))

    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref_loss = np.asarray(jce.chunked_lm_head_xent(
        jx, jw, jnp.asarray(lab), C, cache=True))
    ref_dx, ref_dw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    tx, tw = _bf(x).requires_grad_(), _bf(w).requires_grad_()
    loss = ce.chunked_lm_head_xent(tx, tw, torch.from_numpy(lab), C,
                                   cache=True)
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-5,
                               atol=1e-5)
    (loss * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _close(tx.grad.float(), np.asarray(ref_dx, np.float32), "dx")
    _close(tw.grad.float(), np.asarray(ref_dw, np.float32), "dw")

# -- head-dim padding (the card's route for D below the kernels') ----------

@pytest.mark.parametrize("D", [8, 16, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_d_forward_matches_pallas(D, causal):
    """The wrapper's padding applied on CPU tensors: q, k, v padded to
    the kernel head dim (32 or 64), the plain forward at the original
    D's scale, O sliced back."""
    q, k, v = _bf16_inputs([(2, 2, 40, D), (2, 2, 56, D), (2, 2, 56, D)],
                           seed=D)
    kv_len = [56, 30]
    ref_o, ref_lse = pal.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        kv_len=jnp.asarray(kv_len, jnp.int32), block_q=8, block_k=8,
        interpret=True)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    scale = 1.0 / float(np.sqrt(D))
    o, lse = fa.flash_attn_fwd_padded(
        fa.flash_attn_fwd_plain, *map(torch.from_numpy, (q, k, v)), lens,
        torch.zeros_like(lens), causal, scale)
    assert fa.kernel_head_dim(D, fa.KERNEL_HEAD_DIMS) in (32, 64)
    assert o.shape == (2, 2, 40, D)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("D", [8, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_d_backward_matches_pallas(D, dtype):
    """The backward's padding (D up to 64) on CPU tensors, through the
    split pair's plain versions, against the Pallas gradients at D."""
    q, k, v, do = _bf16_inputs([(2, 2, 48, D), (2, 2, 64, D),
                                (2, 2, 64, D), (2, 2, 48, D)], seed=D + 1)
    kv_len = [64, 37]
    jdt = getattr(jnp, dtype)
    ref = _pallas_grads(q, k, v, do, kv_len, True, jdt)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    lens = torch.tensor(kv_len, dtype=torch.int32)
    scale = 1.0 / float(np.sqrt(D))
    o, lse = fa.flash_attn_fwd(tq, tk, tv, lens, torch.zeros_like(lens),
                               True, scale)
    delta = (tdo.float() * o.float()).sum(-1).contiguous()

    def split(*a):
        return (fa.flash_attn_bwd_dq_plain(*a),
                *fa.flash_attn_bwd_dkv_plain(*a))

    got = fa.flash_attn_bwd_padded(split, tq, tk, tv, tdo, lse, delta,
                                   lens, True, scale)
    assert fa.kernel_head_dim(D, fa.BWD_HEAD_DIMS) == 64
    for name, g, r in zip("qkv", got, ref):
        assert g.shape[-1] == D and g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL,
                                       err_msg=f"d{name}")
        else:
            _close(g.float(), r, f"d{name}")


def test_head_dims_above_64_raise():
    with pytest.raises(ValueError, match="up to 64"):
        fa.kernel_head_dim(80, fa.KERNEL_HEAD_DIMS)
    with pytest.raises(ValueError, match="up to 64"):
        fa.kernel_head_dim(128, fa.BWD_HEAD_DIMS)
    assert [fa.kernel_head_dim(d, fa.KERNEL_HEAD_DIMS)
            for d in (1, 32, 33, 64)] == [32, 32, 64, 64]
