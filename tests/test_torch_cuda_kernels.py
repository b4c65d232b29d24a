"""The port's Hopper kernels on the card, held to their plain versions:
K1 (flash-attention forward), K2-K4 (its backward), K5 (the lm-head
log-sum-exp), K6 (the int8 x int8 -> int32 matmul); the bf16 (amp) K1,
K2, K3, K4 and K5; and head dims below the kernels', zero-padded. The
kernels that sum in several blocks (K5's vocab splits, K2-bf16's
cluster) are also held to the same bits from call to call.

Marked `cuda`: they skip on a machine without a CUDA card (the kernels
have no interpret mode). This file imports neither JAX nor the JAX
package, so on a card machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import _build, flags
from paddle_tpu_torch.ops import chunked_ce as ce
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import quant_ops
from paddle_tpu_torch.ops.registry import get_op


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,kv_len,q_start", [
    (4, 256, 384, [256, 200, 77, 0], [0, 0, 0, 0]),          # cold prefill
    (4, 256, 384, [300, 218, 256, 49], [64, 128, 0, 32]),    # prefix hits
    (8, 1, 384, [384, 1, 17, 250, 100, 64, 333, 5],
     [383, 0, 16, 249, 99, 63, 332, 4]),                     # decode
])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_attn_fwd_kernel_matches_plain(card, B, Tq, Tk, kv_len,
                                             q_start, D):
    rng = np.random.RandomState(Tq + D)
    q, k, v = (torch.from_numpy(rng.randn(B, 12, T, D).astype(np.float32))
               .to(card) for T in (Tq, Tk, Tk))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    starts = torch.tensor(q_start, dtype=torch.int32, device=card)
    before = fa.flash_attn_fwd.launches
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd.launches == before + 1
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts)
    # different summation order (32-key chunks vs one softmax per row)
    assert float((o - ref_o).abs().max()) <= 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    for b, n_live in enumerate(kv_len):
        if n_live == 0:
            assert float(o[b].abs().max()) == 0.0
            assert bool((lse[b] == fa.NEG).all())


@pytest.mark.cuda
def test_flash_attn_fwd_kernel_takes_strided_head_views(card):
    """q/k/v sliced out of a packed [B, T, n, 3, D] qkv plane, as
    _cached_block passes them, without a contiguous copy."""
    rng = np.random.RandomState(7)
    qkv = torch.from_numpy(rng.randn(2, 40, 12, 3, 64).astype(np.float32)
                           ).to(card)
    q, k, v = (qkv[:, :, :, m].transpose(1, 2) for m in range(3))
    lens = torch.tensor([40, 23], dtype=torch.int32, device=card)
    starts = torch.zeros(2, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts)
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts)
    assert float((o - ref_o).abs().max()) <= 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq", [63, 64, 65, 1000])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_attn_fwd_kernel_at_tile_edges(card, causal, Tq, D):
    """The Tq > 1 kernel's 64-row query tiles and 64-key K/V tiles at
    their edges: Tq one either side of a tile, kv_len 0, 1 and one
    either side of a key tile."""
    kv_len = [0, 1, 63, 64, 65]
    Tk = Tq + 7
    rng = np.random.RandomState(Tq * 3 + D)
    q, k, v = (torch.from_numpy(rng.randn(5, 3, T, D).astype(np.float32))
               .to(card) for T in (Tq, Tk, Tk))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    starts = torch.zeros(5, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts, causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts, causal)
    err = max(float((o - ref_o).abs().max()),
              float((lse - ref_lse).abs().max()))
    print(f"K1 Tq {Tq} D {D} causal {causal}: max_abs_err {err:.3e}")
    assert err <= 1e-4
    assert float(o[0].abs().max()) == 0.0      # kv_len 0: fully masked
    assert bool((lse[0] == fa.NEG).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
def test_flash_attn_fwd_kernel_query_offset_at_tile_edges(card, D):
    """Tq > 1 with non-zero q_start (prefix-hit prefill rows): the causal
    limit q_start + row + 1 crosses key tiles inside a query tile."""
    B, Tq, Tk = 4, 130, 320
    kv_len, q_start = [320, 194, 64, 129], [190, 64, 0, 1]
    rng = np.random.RandomState(41 + D)
    q, k, v = (torch.from_numpy(rng.randn(B, 2, T, D).astype(np.float32))
               .to(card) for T in (Tq, Tk, Tk))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    starts = torch.tensor(q_start, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts)
    err = max(float((o - ref_o).abs().max()),
              float((lse - ref_lse).abs().max()))
    print(f"K1 q_start D {D}: max_abs_err {err:.3e}")
    assert err <= 1e-4


@pytest.mark.cuda
def test_flash_attn_fwd_kernel_takes_plane_views_at_training_shape(card):
    """q/k/v as the training op passes them: head views of one packed
    [B, T, 3 * n * D] plane at GPT-2-small's [8, 12, 1024, 64]."""
    B, n, T, D = 8, 12, 1024, 64
    H = n * D
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(B, T, 3 * H).astype(np.float32)).to(card)
    q, k, v = (x[..., i * H:(i + 1) * H].view(B, T, n, D).permute(0, 2, 1, 3)
               for i in range(3))
    lens = torch.full((B,), T, dtype=torch.int32, device=card)
    starts = torch.zeros(B, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts)
    err = max(float((o - ref_o).abs().max()),
              float((lse - ref_lse).abs().max()))
    print(f"K1 plane views [8, 12, 1024, 64]: max_abs_err {err:.3e}")
    assert err <= 1e-4


@pytest.mark.cuda
def test_flash_attn_fwd_kernel_refuses_what_it_does_not_take(card):
    # D <= 64 is zero-padded to the kernel's 32 or 64; above 64 raises
    q = torch.zeros(1, 2, 4, 80, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attn_fwd(q, q, q, lens, lens)
    q64 = torch.zeros(1, 2, 4, 64, device=card)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attn_fwd(q64.double(), q64.double(), q64.double(), lens,
                          lens)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attn_fwd(q64, q64, q64, lens.long(), lens.long())


# -- K1 at Tq = 1: the split-key decode kernel, paged and contiguous --------

def _paged_case(card, B, n, D, page_len, m, kv, seed, extra_pages=5):
    """q [B, n, 1, D] and K/V pools whose pages are handed out to the rows
    in a shuffled order; page 0 (the trash page every unbacked table
    slot names) and every pool row past a row's kv hold NaN, which the
    kernel must never read. q_start = kv - 1 (the decode step)."""
    rng = np.random.RandomState(seed)
    need = [-(-k // page_len) for k in kv]
    P = 1 + sum(need) + extra_pages
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, m), np.int32)
    pools = [rng.randn(P, n, page_len, D).astype(np.float32)
             for _ in range(2)]
    used = 0
    for b in range(B):
        tables[b, :need[b]] = ids[used:used + need[b]]
        used += need[b]
        if need[b] and kv[b] % page_len:
            for pool in pools:       # rows past kv in the last page
                pool[tables[b, need[b] - 1], :, kv[b] % page_len:] = np.nan
    for pool in pools:
        pool[0] = np.nan
    q = rng.randn(B, n, 1, D).astype(np.float32)
    lens = np.asarray(kv, np.int32)
    return (*(torch.from_numpy(a).to(card) for a in (q, *pools, tables)),
            torch.from_numpy(lens).to(card),
            torch.from_numpy(lens - 1).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 8, 48])
@pytest.mark.parametrize("page_len,m,kv", [
    (16, 24, [384, 1, 17, 250, 100, 64, 333, 5]),   # the engine's geometry
    (1, 300, [0, 1, 31, 32, 33, 127, 128, 129, 300]),   # part edges
    (384, 1, [384, 0, 383, 64, 1]),                 # one page a row
    (16, 64, [1024, 513, 1000]),                    # several rounds a part
])
def test_flash_attn_decode_kernel_matches_plain(card, D, page_len, m, kv):
    """Shuffled pages, NaN on the trash page and past each row's length,
    kv from 0 to the whole table; D 8 and 48 run with the tail columns
    of the 32- or 64-wide kernel masked, nothing padded."""
    q, kp, vp, tables, lens, starts = _paged_case(
        card, len(kv), 3, D, page_len, m, kv, seed=page_len + D)
    before = fa.flash_attn_fwd.launches
    o, lse = fa.flash_attn_decode(q, kp, vp, tables, page_len, lens, starts)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd.launches == before + 1
    ref_o, ref_lse = fa.flash_attn_decode_plain(q, kp, vp, tables, page_len,
                                                lens, starts)
    err = max(float((o - ref_o).abs().max()),
              float((lse - ref_lse).abs().max()))
    print(f"K1 decode paged page_len {page_len} D {D}: max_abs_err "
          f"{err:.3e}")
    assert err <= 1e-4
    for b, n_live in enumerate(kv):
        if n_live == 0:
            assert float(o[b].abs().max()) == 0.0
            assert bool((lse[b] == fa.NEG).all())
    again = fa.flash_attn_decode(q, kp, vp, tables, page_len, lens, starts)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_flash_attn_decode_rows_alone_equal_rows_in_the_batch(card, paged):
    """Each row's split depends on its own length only: its O and LSE
    bits are the same computed alone as in a batch of 8."""
    kv = [384, 1, 17, 250, 100, 64, 333, 5]
    q, kp, vp, tables, lens, starts = _paged_case(card, 8, 12, 64, 16, 24,
                                                  kv, seed=5)
    if paged:
        run = (lambda s: fa.flash_attn_decode(
            q[s], kp, vp, tables[s], 16, lens[s], starts[s]))
    else:
        k, v = (fa.gather_pages(p, tables) for p in (kp, vp))
        run = (lambda s: fa.flash_attn_fwd(q[s], k[s], v[s], lens[s],
                                           starts[s]))
    o, lse = run(slice(0, 8))
    for b in range(8):
        ob, lseb = run(slice(b, b + 1))
        assert torch.equal(ob[0], o[b]) and torch.equal(lseb[0], lse[b])


@pytest.mark.cuda
def test_flash_attn_fwd_decode_on_slab_plane_views(card):
    """The contiguous layout as the slab engine passes it: ck[l] of a
    [L, S, n, Tcap, D] plane and q out of a packed qkv plane, one fully
    masked row; one K1 launch, the same bits in two calls."""
    rng = np.random.RandomState(17)
    S, n, Tcap, D = 5, 12, 384, 64
    ck, cv = (torch.from_numpy(rng.randn(2, S, n, Tcap, D).astype(
        np.float32)).to(card) for _ in range(2))
    qkv = torch.from_numpy(rng.randn(S, 1, n, 3, D).astype(np.float32)
                           ).to(card)
    q = qkv[:, :, :, 0].transpose(1, 2)
    kv = [384, 0, 1, 200, 33]
    lens = torch.tensor(kv, dtype=torch.int32, device=card)
    starts = lens - 1
    before = fa.flash_attn_fwd.launches
    o, lse = fa.flash_attn_fwd(q, ck[1], cv[1], lens, starts)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd.launches == before + 1
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, ck[1], cv[1], lens, starts)
    err = max(float((o - ref_o).abs().max()),
              float((lse - ref_lse).abs().max()))
    print(f"K1 decode slab plane: max_abs_err {err:.3e}")
    assert err <= 1e-4
    assert float(o[1].abs().max()) == 0.0 and bool((lse[1] == fa.NEG).all())
    again = fa.flash_attn_fwd(q, ck[1], cv[1], lens, starts)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
def test_flash_attn_decode_refuses_what_it_does_not_take(card):
    q, kp, vp, tables, lens, starts = _paged_case(card, 2, 2, 64, 4, 3,
                                                  [5, 12], seed=3)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attn_decode(q, kp, vp, tables.long(), 4, lens, starts)
    with pytest.raises(ValueError, match="tables"):
        fa.flash_attn_decode(q, kp, vp, tables[:1], 4, lens, starts)
    q80 = torch.zeros(2, 2, 1, 80, device=card)
    k80 = torch.zeros(4, 2, 4, 80, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attn_decode(q80, k80, k80, tables, 4, lens, starts)
    with pytest.raises(NotImplementedError, match="bf16"):
        fa.flash_attn_decode(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                             tables, 4, lens, starts)
    # a table shorter than kv_len is not refused on any device (that
    # would read kv_len back): the kernel reads no key past the table's
    # m * page_len keys, clamping as the plain version does
    short = tables[:, :2].contiguous()       # 8 keys; row 1 has 12
    o, lse = fa.flash_attn_decode(q, kp, vp, short, 4, lens, starts)
    ref_o, ref_lse = fa.flash_attn_decode_plain(q, kp, vp, short, 4, lens,
                                                starts)
    assert bool(torch.isfinite(o).all())
    assert float((o - ref_o).abs().max()) <= 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-4


# -- K2-K4: the flash-attention backward ------------------------------------

def _bwd_case(card, B, n, Tq, Tk, D, kv_len, causal, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, n, T, D).astype(np.float32))
                   .to(card) for T in (Tq, Tk, Tk, Tq))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, torch.zeros_like(lens), causal)
    delta = (do * o).sum(-1).contiguous()
    return q, k, v, do, lse, delta, lens


# tolerance 1e-4 absolute: the kernels sum over 64-key (64-row) tiles in
# another order than the plain version's one product per matrix
BWD_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,n,Tq,Tk,kv_len", [
    (2, 3, 256, 256, [256, 256]),       # nk = 4: the fused K2's range
    (2, 3, 200, 200, [200, 77]),        # ragged T and kv_len
    (3, 2, 100, 300, [300, 150, 0]),    # Tq != Tk, a fully masked batch
    (2, 2, 130, 70, [70, 33]),          # Tq > Tk
])
def test_flash_backward_kernels_match_plain(card, causal, B, n, Tq, Tk,
                                            kv_len):
    q, k, v, do, lse, delta, lens = _bwd_case(card, B, n, Tq, Tk, 64,
                                              kv_len, causal, Tq + Tk)
    ref_dq, ref_dk, ref_dv = fa.flash_attn_bwd_fused_plain(
        q, k, v, do, lse, delta, lens, causal)
    counts = (fa.flash_attn_bwd_fused.launches,
              fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches)
    fused = fa.flash_attn_bwd_fused(q, k, v, do, lse, delta, lens, causal)
    torch.cuda.synchronize()
    dq = fa.flash_attn_bwd_dq(q, k, v, do, lse, delta, lens, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, do, lse, delta, lens, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attn_bwd_fused.launches, fa.flash_attn_bwd_dq.launches,
            fa.flash_attn_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    for name, got, ref in (("K2 dq", fused[0], ref_dq),
                           ("K2 dk", fused[1], ref_dk),
                           ("K2 dv", fused[2], ref_dv), ("K3 dq", dq, ref_dq),
                           ("K4 dk", dk, ref_dk), ("K4 dv", dv, ref_dv)):
        err = float((got - ref).abs().max())
        assert err <= BWD_TOL, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,n,Tq,Tk,kv_len", [
    (True, 32, 12, 256, 256, [256] * 32),       # T 256 training shape
    (True, 3, 4, 190, 250, [250, 131, 64]),     # ragged, Tq < Tk
    (False, 3, 4, 190, 250, [250, 131, 64]),
    (True, 2, 3, 257, 129, [129, 65]),          # ragged, Tq > Tk
    (False, 2, 3, 257, 129, [129, 65]),
])
def test_flash_backward_fused_kernel_at_main_path_and_ragged_shapes(
        card, causal, B, n, Tq, Tk, kv_len):
    """K2 at its own main-path shape [32, 12, 256, 64] and at ragged
    Tq != Tk, against the plain backward."""
    q, k, v, do, lse, delta, lens = _bwd_case(card, B, n, Tq, Tk, 64,
                                              kv_len, causal, Tq * 5 + Tk)
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens,
                                        causal)
    got = fa.flash_attn_bwd_fused(q, k, v, do, lse, delta, lens, causal)
    torch.cuda.synchronize()
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    print(f"K2 [{B},{n},{Tq},{Tk}] causal {causal}: max_abs_err dq "
          f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}")
    assert max(errs) <= BWD_TOL


def _split_plane_case(card, B, n, Tq, Tk, kv_len, causal, seed):
    """A backward case on strided head views of packed planes, as the
    training op passes them: q, k, v from one [B, T, 3*n*64] plane when
    Tq == Tk (else q from its own plane, k and v from one), dO from a
    [B, Tq, n*64] plane."""
    rng = np.random.RandomState(seed)
    H = n * 64
    plane = (lambda T, w: torch.from_numpy(  # noqa: E731
        rng.randn(B, T, w).astype(np.float32)).to(card))
    if Tq == Tk:
        qkv = plane(Tq, 3 * H)
        q, k, v = (fa._heads(qkv[..., i * H:(i + 1) * H], n)
                   for i in range(3))
    else:
        kv = plane(Tk, 2 * H)
        q = fa._heads(plane(Tq, H), n)
        k, v = fa._heads(kv[..., :H], n), fa._heads(kv[..., H:], n)
    do = fa._heads(plane(Tq, H), n)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, torch.zeros_like(lens), causal)
    delta = (do * o).sum(-1).contiguous()
    return q, k, v, do, lse, delta, lens


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,n,Tq,Tk,kv_len", [
    (8, 12, 1024, 1024, [1024] * 8),    # T 1024 training shape
    (2, 2, 63, 63, [63, 62]),           # one short of a 64-row tile
    (2, 2, 64, 64, [64, 63]),           # exactly one tile
    (2, 2, 65, 65, [65, 64]),           # one into a second tile
    (2, 2, 127, 127, [127, 126]),       # one short of 128
    (2, 2, 128, 128, [128, 127]),       # two tiles
    (2, 2, 129, 129, [129, 128]),       # one into a third tile
    (3, 2, 65, 129, [129, 65, 0]),      # Tq < Tk, a batch with kv_len 0
    (3, 2, 129, 63, [63, 0, 1]),        # Tq > Tk, kv_len 0 and 1
    (2, 3, 128, 127, [127, 64]),        # Tq > Tk by one
    (2, 3, 127, 128, [128, 65]),        # Tq < Tk by one
])
def test_flash_backward_split_kernels_at_main_path_and_ragged_shapes(
        card, causal, B, n, Tq, Tk, kv_len):
    """K3 and K4 at their main-path shape [8, 12, 1024, 64] and at the
    64- and 128-row tile edges, on plane views, against the plain
    backward."""
    args = _split_plane_case(card, B, n, Tq, Tk, kv_len, causal,
                             Tq * 3 + Tk)
    ref = fa.flash_attn_bwd_fused_plain(*args, causal)
    counts = (fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches)
    got = (fa.flash_attn_bwd_dq(*args, causal),
           *fa.flash_attn_bwd_dkv(*args, causal))
    torch.cuda.synchronize()
    assert (fa.flash_attn_bwd_dq.launches,
            fa.flash_attn_bwd_dkv.launches) == (counts[0] + 1, counts[1] + 1)
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    print(f"K3/K4 [{B},{n},{Tq},{Tk}] causal {causal}: max_abs_err dq "
          f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}")
    assert max(errs) <= BWD_TOL


@pytest.mark.cuda
def test_flash_backward_kernels_take_plane_views(card):
    """q/k/v head views of one packed qkv plane and plane-allocated
    gradients, as the training op passes them; through the autograd
    Function, against the same Function on the CPU (plain versions)."""
    B, n, T, D = 2, 4, 320, 64
    rng = np.random.RandomState(9)
    qkv = rng.randn(B, T, 3 * n * D).astype(np.float32)
    dout = rng.randn(B, T, n * D).astype(np.float32)
    grads = {}
    for dev in ("cpu", card):
        x = torch.from_numpy(qkv).to(dev).requires_grad_()
        H = n * D
        out = fa.flash_attention_plane(x[..., :H], x[..., H:2 * H],
                                       x[..., 2 * H:], n, causal=True)
        out.backward(torch.from_numpy(dout).to(dev))
        grads[str(dev)] = (out.detach().cpu(), x.grad.cpu())
    for a, b in zip(grads["cpu"], grads[str(card)]):
        assert float((a - b).abs().max()) <= BWD_TOL


@pytest.mark.cuda
def test_flash_backward_kernels_refuse_what_they_do_not_take(card):
    # D <= 64 is zero-padded to the kernels' 64; above 64 raises
    q, k, v, do, lse, delta, lens = _bwd_case(card, 1, 2, 16, 16, 64, [16],
                                              True, 0)
    wide = torch.zeros(1, 2, 16, 96, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attn_bwd_dq(wide, wide, wide, wide, lse, delta, lens)
    q, k, v, do, lse, delta, lens = _bwd_case(card, 1, 2, 16, 16, 64, [16],
                                              True, 0)
    with pytest.raises(TypeError, match="contiguous float32"):
        fa.flash_attn_bwd_dkv(q, k, v, do, lse.double(), delta, lens)


# -- head dims below the kernels' (zero-padded on the card) -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_head_dims_match_plain(card, D, dtype):
    """D 16 and 48 run through the f32 and bf16 kernels padded to 32 /
    64 (forward) and 64 (backward, the split K3 + K4 at Tk > 256),
    against the plain versions at D."""
    B, n, T = 2, 3, 300
    rng = np.random.RandomState(D)
    q, k, v, do = (torch.from_numpy(rng.randn(B, n, T, D).astype(np.float32))
                   .to(card, dtype) for _ in range(4))
    lens = torch.tensor([300, 170], dtype=torch.int32, device=card)
    starts = torch.zeros_like(lens)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, starts)
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    got = fa.flash_attn_bwd(q, k, v, o, lse, do, lens)
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens)
    torch.cuda.synchronize()
    assert o.shape == q.shape and all(g.shape == q.shape for g in got)
    for name, g, r in (("O", o, ref_o), ("dq", got[0], ref[0]),
                       ("dk", got[1], ref[1]), ("dv", got[2], ref[2])):
        err = float((g.float() - r.float()).abs().max())
        tol = (BWD_TOL if dtype == torch.float32
               else BF16_REL * float(r.float().abs().max()))
        assert err <= tol, (name, err)
    assert float((lse - ref_lse).abs().max()) <= 1e-4


# -- the bf16 (amp) kernels: K1, K2, K3, K4 and K5 ------------------------

# bf16 outputs within 1e-2 of the largest |plain| element (two bf16
# ulps): both sum f32 products of the same bf16 operands in other orders
# and round once; f32 outputs (LSE) within 1e-4 absolute
BF16_REL = 1e-2


def _bf16_case(card, B, n, Tq, Tk, D, kv_len, causal, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, n, T, D).astype(np.float32))
                   .to(card, torch.bfloat16) for T in (Tq, Tk, Tk, Tq))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd(q, k, v, lens, torch.zeros_like(lens), causal)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    return q, k, v, do, o, lse, delta, lens


def _bf16_err(got, ref):
    return (float((got.float() - ref.float()).abs().max())
            / float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,Tq,Tk,kv_len,D", [
    (2, 64, 64, [64, 63], 64),           # one tile
    (2, 65, 65, [65, 64], 64),           # one row / key into a second tile
    (3, 200, 333, [333, 129, 0], 64),    # Tq != Tk, a fully masked batch
    (2, 300, 130, [130, 65], 32),        # Tq > Tk, D 32
])
def test_flash_attn_fwd_bf16_kernel_matches_plain(card, causal, B, Tq, Tk,
                                                  kv_len, D):
    q, k, v, _, o, lse, _, lens = _bf16_case(card, B, 4, Tq, Tk, D, kv_len,
                                             causal, Tq + Tk + D)
    before = (fa.flash_attn_fwd.launches, fa.flash_attn_fwd_bf16.launches)
    o, lse = fa.flash_attn_fwd_bf16(q, k, v, lens, torch.zeros_like(lens),
                                    causal)
    torch.cuda.synchronize()
    assert (fa.flash_attn_fwd.launches,
            fa.flash_attn_fwd_bf16.launches) == (before[0], before[1] + 1)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens,
                                             torch.zeros_like(lens), causal)
    err = _bf16_err(o, ref_o)
    print(f"K1-bf16 [{B},4,{Tq},{Tk},{D}] causal {causal}: O {err:.3e} of "
          f"max, LSE {float((lse - ref_lse).abs().max()):.3e}")
    assert err <= BF16_REL
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    for b, n_live in enumerate(kv_len):
        if n_live == 0:
            assert float(o[b].float().abs().max()) == 0.0
            assert bool((lse[b] == fa.NEG).all())


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,n,Tq,Tk,kv_len,q_start", [
    # 4 q blocks x 96 (batch, head)s: more units than 132 SMs
    (True, 8, 12, 1024, 1024, [1024] * 8, [0] * 8),
    # 2 units: fewer than the SMs; Tq not a multiple of 256
    (True, 1, 2, 300, 300, [300], [0]),
    # 144 (batch, head)s, more than the SMs: each head's blocks together
    (True, 12, 12, 520, 520, [520, 1, 300] * 4, [0] * 12),
    # ragged kv_len with a zero, Tq not a multiple of 256
    (True, 4, 3, 700, 700, [700, 513, 0, 1], [0, 0, 0, 0]),
    # query offsets (a prefix of cached keys), causal and not
    (True, 3, 2, 260, 900, [900, 520, 700], [640, 260, 0]),
    (False, 3, 2, 260, 900, [900, 520, 0], [640, 260, 0]),
    (False, 2, 12, 512, 512, [512, 300], [0, 0]),
])
def test_flash_attn_fwd_bf16_kernel_block_order_and_ragged_cases(
        card, causal, B, n, Tq, Tk, kv_len, q_start):
    """K1-bf16 on its persistent grid (units taken heaviest causal block
    first: all heads' when they fit the grid, else each head's) against
    its plain version: more and fewer units than SMs, more (batch,
    head)s than SMs, Tq not a multiple of the 256-row unit, ragged
    kv_len with an empty batch, q_start > 0, non-causal."""
    rng = np.random.RandomState(Tq + Tk + B)
    q, k, v = (torch.from_numpy(rng.randn(B, n, T, 64).astype(np.float32))
               .to(card, torch.bfloat16) for T in (Tq, Tk, Tk))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=card)
    starts = torch.tensor(q_start, dtype=torch.int32, device=card)
    before = fa.flash_attn_fwd_bf16.launches
    o, lse = fa.flash_attn_fwd_bf16(q, k, v, lens, starts, causal)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd_bf16.launches == before + 1
    ref_o, ref_lse = fa.flash_attn_fwd_plain(q, k, v, lens, starts, causal)
    err = _bf16_err(o, ref_o)
    lse_err = float((lse - ref_lse).abs().max())
    print(f"K1-bf16 [{B},{n},{Tq},{Tk}] causal {causal}: O {err:.3e} of "
          f"max, LSE {lse_err:.3e}")
    assert err <= BF16_REL
    assert lse_err <= 1e-4
    for b, n_live in enumerate(kv_len):
        if n_live == 0:
            assert float(o[b].float().abs().max()) == 0.0
            assert bool((lse[b] == fa.NEG).all())


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,n,Tq,Tk,kv_len", [
    (True, 2, 12, 1024, 1024, [1024, 1024]),    # the training length
    (True, 3, 4, 300, 500, [500, 257, 0]),      # Tq != Tk, ragged
    (False, 3, 4, 300, 500, [500, 257, 0]),
    (True, 2, 3, 600, 270, [270, 65]),          # Tq > Tk
])
def test_flash_backward_bf16_kernels_match_plain(card, causal, B, n, Tq, Tk,
                                                 kv_len):
    q, k, v, do, o, lse, delta, lens = _bf16_case(card, B, n, Tq, Tk, 64,
                                                  kv_len, causal, Tq * 3 + Tk)
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens,
                                        causal)
    counts = (fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches,
              fa.flash_attn_bwd_dq_bf16.launches,
              fa.flash_attn_bwd_dkv_bf16.launches)
    dq = fa.flash_attn_bwd_dq_bf16(q, k, v, do, lse, delta, lens, causal)
    dk, dv = fa.flash_attn_bwd_dkv_bf16(q, k, v, do, lse, delta, lens,
                                        causal)
    torch.cuda.synchronize()
    assert (fa.flash_attn_bwd_dq.launches, fa.flash_attn_bwd_dkv.launches,
            fa.flash_attn_bwd_dq_bf16.launches,
            fa.flash_attn_bwd_dkv_bf16.launches) == (
                counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    errs = [_bf16_err(g, r) for g, r in zip((dq, dk, dv), ref)]
    print(f"K3/K4-bf16 [{B},{n},{Tq},{Tk}] causal {causal}: dq {errs[0]:.3e}"
          f" dk {errs[1]:.3e} dv {errs[2]:.3e} of max")
    assert all(g.dtype == torch.bfloat16 for g in (dq, dk, dv))
    assert max(errs) <= BF16_REL
    if 0 in kv_len:
        b = kv_len.index(0)
        assert float(dk[b].float().abs().max()) == 0.0
        assert float(dv[b].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("causal,B,n,Tq,Tk,kv_len", [
    (True, 32, 12, 256, 256, [256] * 32),       # the amp T 256 main path
    (True, 2, 3, 64, 64, [64, 63]),             # nk = 1
    (False, 2, 3, 100, 100, [100, 65]),         # nk = 2, Tk not 64k
    (True, 3, 4, 190, 190, [190, 131, 0]),      # nk = 3, ragged, empty
    (False, 3, 4, 130, 250, [250, 64, 1]),      # nk = 4, Tq < Tk
    (True, 2, 3, 300, 256, [256, 129]),         # Tq > Tk
])
def test_flash_backward_fused_bf16_kernel_matches_plain(card, causal, B, n,
                                                        Tq, Tk, kv_len):
    """K2-bf16 at its main-path shape and across nk = 1-4 kv tiles,
    ragged kv_len and Tq != Tk, against the plain bf16 backward; dq comes
    back bf16 (the f32 partials summed and cast once)."""
    q, k, v, do, o, lse, delta, lens = _bf16_case(card, B, n, Tq, Tk, 64,
                                                  kv_len, causal, Tq * 7 + Tk)
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens,
                                        causal)
    counts = (fa.flash_attn_bwd_fused.launches,
              fa.flash_attn_bwd_fused_bf16.launches)
    got = fa.flash_attn_bwd_fused_bf16(q, k, v, do, lse, delta, lens,
                                       causal)
    torch.cuda.synchronize()
    assert (fa.flash_attn_bwd_fused.launches,
            fa.flash_attn_bwd_fused_bf16.launches) == (counts[0],
                                                       counts[1] + 1)
    assert all(g.dtype == torch.bfloat16 for g in got)
    errs = [_bf16_err(g, r) for g, r in zip(got, ref)]
    print(f"K2-bf16 [{B},{n},{Tq},{Tk}] causal {causal}: dq {errs[0]:.3e} "
          f"dk {errs[1]:.3e} dv {errs[2]:.3e} of max")
    assert max(errs) <= BF16_REL
    if 0 in kv_len:
        b = kv_len.index(0)
        assert all(float(g[b].float().abs().max()) == 0.0 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk,kv_len", [
    (64, 64, [64, 40]),          # a cluster of one block
    (65, 65, [65, 65]),          # one key into the second 64-key box
    (128, 128, [128, 100]),      # one block, both boxes
    (129, 129, [129, 129]),      # a cluster of 2: one key in block 1
    (192, 192, [192, 150]),
    (256, 256, [256, 256]),      # the main path's Tk
    (256, 256, [256, 128, 0]),   # ragged: block 1 holds no live key
    (300, 200, [200, 129]),      # Tq > Tk
    (100, 256, [256, 130]),      # Tq < Tk: causal, block 1 sees no q tile
    (512, 512, [512, 300]),      # a cluster of 4 (the chain)
    (1024, 1024, [1024, 700]),   # the largest cluster, 8 blocks
])
def test_flash_backward_fused_bf16_sums_dq_on_chip(card, causal, Tq, Tk,
                                                   kv_len):
    """K2-bf16 (a cluster of ceil(Tk / 128) blocks summing dq through
    distributed shared memory) against the plain bf16 backward at 1e-2
    of the largest plain element, at clusters of 1, 2, 4 and 8 blocks,
    ragged kv_len and Tq != Tk; two calls give the same bits, and no f32
    dq partial buffer is allocated."""
    B, n = len(kv_len), 3
    q, k, v, do, o, lse, delta, lens = _bf16_case(card, B, n, Tq, Tk, 64,
                                                  kv_len, causal, Tq + 5 * Tk)
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens,
                                        causal)
    before = (fa.flash_attn_bwd_fused_bf16.launches,
              fa.flash_attn_bwd_fused.dq_partials)
    got = fa.flash_attn_bwd_fused_bf16(q, k, v, do, lse, delta, lens,
                                       causal)
    again = fa.flash_attn_bwd_fused_bf16(q, k, v, do, lse, delta, lens,
                                         causal)
    torch.cuda.synchronize()
    assert (fa.flash_attn_bwd_fused_bf16.launches,
            fa.flash_attn_bwd_fused.dq_partials) == (before[0] + 2,
                                                     before[1])
    assert all(g.dtype == torch.bfloat16 for g in got)
    errs = [_bf16_err(g, r) for g, r in zip(got, ref)]
    print(f"K2-bf16 [{B},{n},{Tq},{Tk}] kv_len {kv_len} causal {causal}: "
          f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} of max")
    assert max(errs) <= BF16_REL
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for b, n_live in enumerate(kv_len):
        if n_live == 0:
            assert all(float(g[b].float().abs().max()) == 0.0 for g in got)


@pytest.mark.cuda
def test_flash_backward_fused_bf16_refuses_more_than_eight_blocks(card):
    """K2-bf16's cluster holds at most 8 blocks of 128 keys: Tk 1025
    raises (no fallback) and launches nothing."""
    q, k, v, do, o, lse, delta, lens = _bf16_case(card, 1, 2, 64, 1025, 64,
                                                  [1025], True, 1)
    before = fa.flash_attn_bwd_fused_bf16.launches
    with pytest.raises(RuntimeError, match="Tk <= 1024"):
        fa.flash_attn_bwd_fused_bf16(q, k, v, do, lse, delta, lens, True)
    assert fa.flash_attn_bwd_fused_bf16.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 1024])
def test_bf16_backward_kernels_take_plane_views(card, T):
    """K2-bf16 (T 256) and the split K3 + K4-bf16 (T 1024) on bf16 head
    views of one packed [2, T, 3 * 768] plane and a dO plane, as the
    training op passes them, against the plain backward on the same
    views; each route launches only its own kernels."""
    B, n, D = 2, 12, 64
    H = n * D
    rng = np.random.RandomState(T)
    qkv = torch.from_numpy(rng.randn(B, T, 3 * H).astype(np.float32)).to(
        card, torch.bfloat16)
    do = fa._heads(torch.from_numpy(rng.randn(B, T, H).astype(np.float32))
                   .to(card, torch.bfloat16), n)
    q, k, v = (fa._heads(qkv[..., i * H:(i + 1) * H], n) for i in range(3))
    lens = torch.full((B,), T, dtype=torch.int32, device=card)
    o, lse = fa.flash_attn_fwd_bf16(q, k, v, lens, torch.zeros_like(lens),
                                    True)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    names = ("flash_attn_bwd_fused_bf16", "flash_attn_bwd_dq_bf16",
             "flash_attn_bwd_dkv_bf16")
    before = [getattr(fa, m).launches for m in names]
    got = fa.flash_attn_bwd(q, k, v, o, lse, do, lens, True)
    torch.cuda.synchronize()
    fused = fa.bwd_route(T) == "fused"
    assert [getattr(fa, m).launches - c for m, c in zip(names, before)] == (
        [1, 0, 0] if fused else [0, 1, 1])
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens, True)
    errs = [_bf16_err(g, r) for g, r in zip(got, ref)]
    print(f"bf16 backward plane views [2, 12, {T}, 64] "
          f"({'K2' if fused else 'K3 + K4'}): dq {errs[0]:.3e} dk "
          f"{errs[1]:.3e} dv {errs[2]:.3e} of max")
    assert max(errs) <= BF16_REL


@pytest.mark.cuda
def test_bf16_attention_op_on_plane_views_at_the_training_shape(card):
    """The training op's autograd Function on bf16 q/k/v head views of
    one packed [8, 1024, 3 * 768] plane: K1-bf16 forward, K3 + K4-bf16
    backward, against the plain versions through the same views."""
    B, n, T, D = 8, 12, 1024, 64
    H = n * D
    rng = np.random.RandomState(11)
    qkv = torch.from_numpy(rng.randn(B, T, 3 * H).astype(np.float32)).to(
        card, torch.bfloat16)
    dout = torch.from_numpy(rng.randn(B, T, H).astype(np.float32)).to(
        card, torch.bfloat16)
    x = qkv.clone().requires_grad_()
    before = (fa.flash_attn_fwd_bf16.launches,
              fa.flash_attn_bwd_dq_bf16.launches,
              fa.flash_attn_bwd_dkv_bf16.launches)
    out = fa.flash_attention_plane(x[..., :H], x[..., H:2 * H],
                                   x[..., 2 * H:], n, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.flash_attn_fwd_bf16.launches,
            fa.flash_attn_bwd_dq_bf16.launches,
            fa.flash_attn_bwd_dkv_bf16.launches) == tuple(
                c + 1 for c in before)
    heads = [fa._heads(t, n) for t in (qkv[..., :H], qkv[..., H:2 * H],
                                       qkv[..., 2 * H:])]
    lens = torch.full((B,), T, dtype=torch.int32, device=card)
    starts = torch.zeros_like(lens)
    ref_o, ref_lse = fa.flash_attn_fwd_plain(*heads, lens, starts)
    ref_out = fa._merge(ref_o)
    do = fa._heads(dout, n)
    delta = (do.float() * ref_o.float()).sum(-1).contiguous()
    ref_g = fa.flash_attn_bwd_fused_plain(*heads, do, ref_lse, delta, lens)
    ref_grad = torch.cat([fa._merge(g) for g in ref_g], dim=2)
    e_out, e_grad = _bf16_err(out, ref_out), _bf16_err(x.grad, ref_grad)
    print(f"bf16 plane [8, 12, 1024, 64]: O {e_out:.3e}, dqkv "
          f"{e_grad:.3e} of max")
    assert e_out <= BF16_REL and e_grad <= BF16_REL


@pytest.mark.cuda
def test_bf16_paths_without_a_kernel_raise(card):
    """No fallback: the bf16 decode step (Tq = 1) has no kernel and
    raises; so do mixed dtypes. The bf16 route at Tk <= 256 runs the
    fused K2-bf16 and matches its plain version."""
    q, k, v, do, o, lse, delta, lens = _bf16_case(card, 1, 2, 64, 64, 64,
                                                  [64], True, 0)
    before = fa.flash_attn_bwd_fused_bf16.launches
    got = fa.flash_attn_bwd(q, k, v, o, lse, do, lens)      # route: K2
    torch.cuda.synchronize()
    assert fa.flash_attn_bwd_fused_bf16.launches == before + 1
    ref = fa.flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, lens)
    assert max(_bf16_err(g, r) for g, r in zip(got, ref)) <= BF16_REL
    with pytest.raises(NotImplementedError, match="decode"):
        fa.flash_attn_fwd(q[:, :, :1], k, v, lens, lens - 1)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attn_fwd(q, k.float(), v, lens, torch.zeros_like(lens))
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attn_fwd_bf16(q.float(), k.float(), v.float(), lens,
                               torch.zeros_like(lens))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(8192, 768, 50304), (300, 768, 5000),
                                   (64, 64, 96), (5, 32, 72),
                                   (1, 768, 50304),     # N = 1
                                   (200, 768, 104),     # V below one tile
                                   (333, 96, 1000)])    # N, V, H ragged
def test_lm_head_lse_bf16_kernel_matches_plain(card, N, H, V):
    rng = np.random.RandomState(N + V)
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(
        card, torch.bfloat16)
    w = torch.from_numpy((rng.randn(H, V) * 0.05).astype(np.float32)).to(
        card, torch.bfloat16)
    before = (ce.lm_head_lse.launches, ce.lm_head_lse_bf16.launches)
    got = ce.lm_head_lse_bf16(x, w)
    torch.cuda.synchronize()
    assert (ce.lm_head_lse.launches,
            ce.lm_head_lse_bf16.launches) == (before[0], before[1] + 1)
    ref = ce.lm_head_lse_plain(x, w)
    err = float((got - ref).abs().max())
    print(f"K5-bf16 [{N},{H}] @ [{H},{V}]: max_abs_err {err:.3e}")
    # f32 sums of exact bf16 products, in another order: 1e-4 absolute on
    # values of order log(V)
    assert err <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V,splits", [
    (8192, 768, 50304, 1),       # one split: every tile in one unit
    (8192, 768, 50304, 33),      # the training shape's splits
    (8192, 768, 50304, 197),     # one 256-column tile a split
    (300, 768, 5000, 7),         # N not a multiple of 128, ragged splits
    (129, 64, 50304, 4),         # one row into a third row block
    (1, 768, 1000, 3),           # N = 1
    (200, 32, 8, 5),             # V below one tile: one split used
])
def test_lm_head_lse_bf16_kernel_splits_and_merges(card, N, H, V, splits):
    """The bf16 K5's C entry at a given split count (the wrapper picks
    one by lse_splits) against the plain version at 1e-4 absolute: N, V
    and the split width ragged, V not a multiple of the 256-column tile,
    V below one tile; two calls give the same bits."""
    rng = np.random.RandomState(N + H + V + splits)
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(
        card, torch.bfloat16)
    w = torch.from_numpy((rng.randn(H, V) * 0.05).astype(np.float32)).to(
        card, torch.bfloat16)
    fn = ce._lse_lib(torch.bfloat16)
    stream = torch.cuda.current_stream(card).cuda_stream
    outs = []
    for _ in range(2):
        lse = torch.empty(N, dtype=torch.float32, device=card)
        scratch = torch.full((2, splits, N), float("nan"),
                             dtype=torch.float32, device=card)
        assert fn(x.data_ptr(), w.data_ptr(), lse.data_ptr(),
                  scratch.data_ptr(), N, H, V, x.stride(0), w.stride(0),
                  splits, stream) == 0
        outs.append(lse)
    torch.cuda.synchronize()
    err = float((outs[0] - ce.lm_head_lse_plain(x, w)).abs().max())
    print(f"K5-bf16 [{N},{H}] @ [{H},{V}] splits {splits}: max_abs_err "
          f"{err:.3e}")
    assert err <= 1e-4
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_lm_head_lse_bf16_wrapper_counts_one_launch_and_repeats(card):
    """One call of the bf16 wrapper (the split kernel and its merge)
    counts one launch on lm_head_lse_bf16 and none on the f32 K5; two
    calls at the B 32 amp step's N give the same bits."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(32768, 768).astype(np.float32)).to(
        card, torch.bfloat16)
    w = torch.from_numpy((rng.randn(768, 50304) * 0.02).astype(np.float32)
                         ).to(card, torch.bfloat16)
    before = (ce.lm_head_lse.launches, ce.lm_head_lse_bf16.launches)
    got = ce.lm_head_lse_bf16(x, w)
    assert (ce.lm_head_lse.launches,
            ce.lm_head_lse_bf16.launches) == (before[0], before[1] + 1)
    again = ce.lm_head_lse(x, w)
    torch.cuda.synchronize()
    assert ce.lm_head_lse_bf16.launches == before[1] + 2
    assert torch.equal(got, again)
    err = float((got[:4096] - ce.lm_head_lse_plain(x[:4096], w)).abs().max())
    assert err <= 1e-4


@pytest.mark.cuda
def test_lm_head_lse_bf16_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(4, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte rows"):
        ce.lm_head_lse(x, torch.zeros(64, 70, device=card,
                                      dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="one dtype"):
        ce.lm_head_lse(x, torch.zeros(64, 72, device=card))


# -- K5: the lm-head log-sum-exp --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(300, 768, 5000), (64, 64, 96),
                                   (1000, 128, 50304), (5, 32, 70)])
def test_lm_head_lse_kernel_matches_plain(card, N, H, V):
    rng = np.random.RandomState(N + V)
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(H, V) * 0.05).astype(np.float32)
                         ).to(card)
    before = ce.lm_head_lse.launches
    got = ce.lm_head_lse(x, w)
    torch.cuda.synchronize()
    assert ce.lm_head_lse.launches == before + 1
    ref = ce.lm_head_lse_plain(x, w)
    # f32 dot products over H in another order, then a log of a sum of
    # V exponentials: 1e-4 absolute on values of order log(V)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [
    (8192, 768, 50304),     # the training shape (33 vocab splits)
    (300, 768, 5000),       # N not a multiple of 128, a ragged last tile
    (200, 32, 100),         # V below one 128-column tile
    (129, 64, 1000),        # one row into a second row block
    (1000, 768, 50257),     # V odd: w read 4 bytes at a time
    (64, 32, 70),
])
def test_lm_head_lse_kernel_splits_and_merges(card, N, H, V):
    """The f32 K5 (3xTF32 products, the vocab cut into splits whose (max,
    denominator) a second pass merges in order) against its plain version
    at 1e-4 absolute, with N, V and the split width ragged and H from 32
    to 768; two calls give the same bits."""
    rng = np.random.RandomState(N + H + V)
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(H, V) * 0.05).astype(np.float32)
                         ).to(card)
    before = ce.lm_head_lse.launches
    got = ce.lm_head_lse(x, w)
    again = ce.lm_head_lse(x, w)
    torch.cuda.synchronize()
    assert ce.lm_head_lse.launches == before + 2
    ref = ce.lm_head_lse_plain(x, w)
    err = float((got - ref).abs().max())
    print(f"K5 [{N},{H}] @ [{H},{V}]: max_abs_err {err:.3e}")
    assert err <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,V", [
    (2048, 1024, 50304),    # GPT-2-medium's head: 16 k chunks
    (300, 1000, 5000),      # the last 64-deep k chunk ragged (40 deep)
    (129, 1600, 1000),      # past any H a kernel held before (768)
])
def test_lm_head_lse_kernels_past_h_768(card, dtype, N, H, V):
    """Both K5 kernels stream x and w in 64-deep k chunks, so H is not
    bounded: against the plain version at 1e-4 absolute, two calls the
    same bits."""
    rng = np.random.RandomState(N + H)
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.randn(H, V) * 0.03).astype(np.float32)).to(
        card, dtype)
    got, again = ce.lm_head_lse(x, w), ce.lm_head_lse(x, w)
    torch.cuda.synchronize()
    err = float((got - ce.lm_head_lse_plain(x, w)).abs().max())
    print(f"K5 {dtype} [{N},{H}] @ [{H},{V}]: max_abs_err {err:.3e}")
    assert err <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_lm_head_lse_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(4, 1022, device=card)
    with pytest.raises(ValueError, match="a multiple of 4 with"):
        ce.lm_head_lse(x, torch.zeros(1022, 10, device=card))
    with pytest.raises(TypeError, match="float32"):
        ce.lm_head_lse(x[:, :64].double(),
                       torch.zeros(64, 10, device=card).double())


# -- K6: the int8 matmul ----------------------------------------------------

def _int8_operands(rng, M, K, N):
    """Asymmetric int8 operands over the whole range: a lane-order or
    k-packing fault in the kernel does not cancel out on them."""
    x = rng.randint(-127, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    x[0, :] = 127
    x[-1, ::3] = -127
    w[:, 0] = np.arange(K) % 255 - 127
    w[K // 2, :] = -127
    return x, w


INT8_SHAPES = [
    (256, 768, 2304), (256, 768, 768), (256, 768, 3072),   # GPT-2 blocks
    (256, 3072, 768), (128, 768, 50304),                   # ffn down, head
    (1000, 100, 130), (1, 16, 16), (17, 33, 5), (1024, 64, 8)]


def _laid_out(w, layout):
    """The weight on the card row-major, or column-major as
    quant.place_int8_weights stores it (same shape and values)."""
    return w if layout == "row" else w.t().contiguous().t()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_matmul_kernel_bitwise_equals_plain(card, M, K, N, layout):
    """K6 with its int32 epilogue, bitwise against the plain product, on
    a column-major weight (read as it is) and a row-major one (repacked
    per call, counted)."""
    x, w = _int8_operands(np.random.RandomState(M + K + N), M, K, N)
    xq = torch.from_numpy(x).to(card)
    wq = _laid_out(torch.from_numpy(w).to(card), layout)
    w8 = quant_ops.int8_matmul_i32
    before = (w8.launches, w8.repacks, w8.k_pads)
    got = w8(xq, wq)
    torch.cuda.synchronize()
    assert (w8.launches, w8.repacks, w8.k_pads) == (
        before[0] + 1, before[1] + (layout == "row"),
        before[2] + (K % 16 != 0))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    # exact: int32 sums of int8 products, float64 in the plain version
    assert torch.equal(got.cpu(), quant_ops.int8_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(w)))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["dynamic", "static"])
@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_matmul_rescaled_kernel_bitwise_equals_plain(card, M, K, N,
                                                          layout, act):
    """K6 with the rescale in its epilogue: f32(acc) * ax[row] * col[n]
    bit for bit the plain rescale of the plain product, with per-row
    and static activation scales."""
    rng = np.random.RandomState(M + K + N + 1)
    x, w = _int8_operands(rng, M, K, N)
    xq = torch.from_numpy(x).to(card)
    wq = _laid_out(torch.from_numpy(w).to(card), layout)
    col = torch.from_numpy(rng.rand(1, N).astype(np.float32) * 1e-2 + 1e-4
                           ).to(card)
    ax = torch.from_numpy(rng.rand(M, 1).astype(np.float32) * 0.1
                          if act == "dynamic" else
                          np.full((1, 1), 0.0173, np.float32)).to(card)
    w8 = quant_ops.int8_matmul_rescaled
    before = (w8.launches, w8.repacks)
    got = w8(xq, wq, ax, col)
    torch.cuda.synchronize()
    assert (w8.launches, w8.repacks) == (before[0] + 1,
                                         before[1] + (layout == "row"))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ref = quant_ops.rescale(quant_ops.int8_matmul_plain(xq, wq), ax, col)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.cuda
def test_int8_matmul_kernel_refuses_what_it_does_not_take(card):
    """Row-major and column-major weights run; any other stride, a
    non-int8 operand or mismatched shapes raise."""
    x = torch.zeros(4, 8, dtype=torch.int8, device=card)
    w = torch.zeros(8, 4, dtype=torch.int8, device=card)
    with pytest.raises(TypeError, match="int8"):
        quant_ops.int8_matmul_i32(x.float(), w)
    with pytest.raises(ValueError, match="row-major or column-major"):
        quant_ops.int8_matmul_i32(x, torch.zeros(8, 8, dtype=torch.int8,
                                                 device=card)[:, ::2])
    with pytest.raises(ValueError, match="contiguous row-major xq"):
        quant_ops.int8_matmul_i32(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="takes xq"):
        quant_ops.int8_matmul_i32(x, w[:4])
    with pytest.raises(ValueError, match="ax of M=4 rows"):
        quant_ops.int8_matmul_rescaled(x, w, torch.ones(3, 1, device=card),
                                       torch.ones(4, device=card))
    for wq in (w, w.t().contiguous().t()):
        assert not quant_ops.int8_matmul_i32(x, wq).any()


def _quantize_rows(rng, M, K):
    """Activations with the rows the quantize must get right: wide and
    narrow rows, a row of zeros (ax = tiny, xq = 0) and a row of exact
    halves (max 127 * 2^-3, so ax = 2^-3 and x / ax = k + 1/2: round half
    to even decides)."""
    x = rng.randn(M, K).astype(np.float32)
    x[0] *= 40.0
    x[1] *= 1e-3
    x[2] = 0.0
    if M > 3:
        x[3] = ((np.arange(K) % 253) - 126 + 0.5) * 0.125
        x[3, 0] = 127 * 0.125
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["dynamic", "static"])
@pytest.mark.parametrize("M,K", [(8192, 768), (8192, 3072), (300, 100),
                                 (5, 33), (4, 1)])
def test_quantize_kernel_bitwise_equals_plain(card, M, K, act):
    """The activation quantize kernel against quantize_activations_plain,
    bit for bit: xq, and ax per row or the clamped static scale."""
    rng = np.random.RandomState(M + K)
    x = torch.from_numpy(_quantize_rows(rng, M, K)).to(card)
    scale = None if act == "dynamic" else torch.tensor([0.0125],
                                                       device=card)
    before = quant_ops.quantize_activations.launches
    xq, ax = quant_ops.quantize_activations(x, scale)
    torch.cuda.synchronize()
    assert quant_ops.quantize_activations.launches == before + 1
    ref_q, ref_ax = quant_ops.quantize_activations_plain(x, scale)
    assert xq.dtype == torch.int8 and ax.shape == ref_ax.shape
    assert torch.equal(ax, ref_ax) and torch.equal(xq, ref_q)
    if act == "dynamic":
        assert float(ax[2, 0]) == torch.finfo(torch.float32).tiny
        assert not xq[2].any()
    if M > 3 and K > 1 and act == "dynamic":
        assert float(ax[3, 0]) == 0.125     # the tie row hit its halves
    # a strided row view (every other column) quantizes the same
    wide = torch.from_numpy(np.repeat(_quantize_rows(rng, 6, K), 2, 1)
                            ).to(card)[:, ::2]
    got = quant_ops.quantize_activations(wide, scale)
    ref = quant_ops.quantize_activations_plain(wide, scale)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "pallas", "dot"])
@pytest.mark.parametrize("layout", ["col", "row"])
def test_quant_mul_on_the_card_runs_k6_or_raises(card, mode, layout,
                                                 monkeypatch):
    """Every flag value takes the quantize kernel and K6 with its
    rescale epilogue on a CUDA tensor, once each, bitwise the plain
    recompute; a row-major weight is repacked. When the kernels' library
    cannot load, quant_mul raises — no dequant route, no plain
    fallback."""
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.randint(-127, 128, (64, 32)).astype(np.int8)
                         ).to(card)
    ins = {"X": [torch.from_numpy(rng.randn(2, 8, 64).astype(np.float32)
                                  ).to(card)],
           "Y": [_laid_out(y, layout)],
           "YScale": [torch.full((1, 32), 0.01, device=card)]}
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    flags.set_flag("int8_matmul", mode)
    wrappers = (quant_ops.quantize_activations,
                quant_ops.int8_matmul_rescaled, quant_ops.int8_matmul_i32)
    try:
        before = [w.launches for w in wrappers]
        repacks = quant_ops.int8_matmul_rescaled.repacks
        out = get_op("quant_mul").lowering(None, ins, attrs)["Out"][0]
        assert [w.launches for w in wrappers] == [before[0] + 1,
                                                  before[1] + 1, before[2]]
        assert quant_ops.int8_matmul_rescaled.repacks == repacks + (
            layout == "row")
        assert out.shape == (2, 8, 32) and out.device.type == "cuda"
        xq, ax = quant_ops.quantize_activations_plain(
            ins["X"][0].reshape(16, 64))
        ref = quant_ops.rescale(quant_ops.int8_matmul_plain(xq, y), ax,
                                ins["YScale"][0])
        assert torch.equal(out.reshape(16, 32), ref)

        def unloadable(name):
            raise OSError(f"lib{name}.so: cannot open shared object file")
        monkeypatch.setattr(_build, "load_library", unloadable)
        with pytest.raises(OSError, match="int8_matmul"):
            get_op("quant_mul").lowering(None, ins, attrs)
    finally:
        flags.set_flag("int8_matmul", "auto")


@pytest.mark.cuda
def test_int8_weights_are_column_major_on_the_card(card, tmp_path):
    """A quantized model loaded onto the card holds its int8 matmul
    weights column-major (same values and bytes as on the CPU), saves
    back the same arrays and runs the int8 path without a repack."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quant
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tok = pt.layers.data("tokens", [16], dtype="int64")
        logits = pt.models.transformer.transformer_lm(
            tok, 256, hid=128, num_layers=2, num_heads=2, max_len=16)
    cpu = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    cpu.run(startup, scope=scope)
    src, dst = str(tmp_path / "f32"), str(tmp_path / "int8")
    pt.io.save_inference_model(src, ["tokens"], [logits], cpu,
                               main_program=main, scope=scope)
    quant.quantize_inference_model(src, dst, executor=cpu)
    host, dev = pt.Scope(), pt.Scope()
    hprog, _, _ = pt.io.load_inference_model(dst, cpu, scope=host)
    prog, _, fetch = pt.io.load_inference_model(dst, pt.Executor(),
                                                scope=dev)
    names = {op.input("Y")[0] for op in prog.global_block().ops
             if op.type == "quant_mul"}
    assert len(names) == 2 * 4 + 1
    for n in names:
        w, h = dev.get(n), host.get(n)
        assert quant_ops.is_column_major(w) and h.is_contiguous()
        assert w.shape == h.shape and torch.equal(w.cpu(), h)
    assert quant.place_int8_weights(prog, dev) == 0
    pt.io.save_inference_model(str(tmp_path / "again"), ["tokens"], fetch,
                               pt.Executor(), main_program=prog, scope=dev)
    with np.load(str(tmp_path / "again" / "params.npz")) as a, \
            np.load(str(tmp_path / "int8" / "params.npz")) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    repacks = quant_ops.int8_matmul_rescaled.repacks
    before = quant_ops.int8_matmul_rescaled.launches
    pt.Executor().run(prog, feed={"tokens": np.arange(32).reshape(2, 16)},
                      fetch_list=fetch, scope=dev)
    assert quant_ops.int8_matmul_rescaled.launches == before + len(names)
    assert quant_ops.int8_matmul_rescaled.repacks == repacks


# -- the stacked transformer ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_transformer_stack_on_the_card_matches_its_cpu_plain_run(
        card, dtype, remat):
    """The transformer_stack op (2 layers, H 128, 2 heads of D 64, T 130)
    on the card, where K1 and K3 + K4 run (T > 256), against the same op
    on the CPU, where their plain versions run: Out and the 13 input
    gradients within 1e-4 of their largest element in f32, 3e-2 in bf16
    (other summation orders, bf16 roundings in other places). The
    launches: K1 twice a layer with remat, once without."""
    from paddle_tpu_torch.ops import transformer_ops as T
    rng = np.random.RandomState(3)
    B, L, H, Tn = 2, 2, 128, 130
    shapes = {"X": (B, Tn, H), "Ln1G": (L, H), "Ln1B": (L, H),
              "Wqkv": (L, H, 3 * H), "Bqkv": (L, 3 * H), "Wproj": (L, H, H),
              "Bproj": (L, H), "Ln2G": (L, H), "Ln2B": (L, H),
              "Wup": (L, H, 4 * H), "Bup": (L, 4 * H), "Wdown": (L, 4 * H, H),
              "Bdown": (L, H)}
    arrays = {n: (rng.randn(*s) * (1.0 if n in ("X", "Ln1G", "Ln2G")
                                   else 0.1)).astype(np.float32)
              for n, s in shapes.items()}
    cot = rng.randn(B, Tn, H).astype(np.float32)
    attrs = {"num_heads": 2, "causal": True}
    fwd = (fa.flash_attn_fwd_bf16 if dtype == torch.bfloat16
           else fa.flash_attn_fwd)
    prev = flags.get("remat")
    flags.set_flag("remat", remat)
    try:
        runs = []
        for dev in ("cpu", card):
            leaves = {n: torch.from_numpy(a).to(dev, dtype).requires_grad_()
                      for n, a in arrays.items()}
            before = fwd.launches
            out = T._transformer_stack(None, {n: [v] for n, v in
                                              leaves.items()},
                                       attrs)["Out"][0]
            grads = torch.autograd.grad(
                out, list(leaves.values()),
                torch.from_numpy(cot).to(dev, dtype))
            launched = fwd.launches - before
            runs.append([out.detach().float().cpu()]
                        + [g.float().cpu() for g in grads])
        assert launched == (2 * L if remat else L)
    finally:
        flags.set_flag("remat", prev)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    for name, ref, got in zip(["Out"] + list(arrays), *runs):
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        print(f"stack {dtype} remat {remat} {name}: {err / scale:.2e}")
        assert err <= tol * scale, (name, err, scale)
