"""K1 at Tq = 1 read through a page table: `flash_attn_decode_plain` (the
reference's gather-then-attend) and `flash_attn_decode_split_plain` (the
decode kernel's split of each row's keys and its merge in part order)
against the JAX Pallas K1 in interpret mode on the gathered view, the
split's independence of the batch, and the wrapper's CPU routing and
checks. The paged decode step itself gathers nothing.

The Hopper kernel (csrc/flash_attn_fwd.cu::flash_decode_kernel) has no
interpret mode: tests/test_torch_cuda_kernels.py holds it to these plain
versions on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_attention as pal
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import transformer_ops as PT

TOL = 2e-5   # the JAX suite's own flash tolerance (test_pallas_attention)


def _paged(B, n, D, page_len, m, kv, seed):
    """q [B, n, 1, D] and K/V pools whose pages go to the rows in a
    shuffled order. Page 0 (the trash page of every unbacked slot) and
    the pool rows past each row's kv hold NaN. Returns numpy arrays and
    the rows' gathered views with the keys that are not live zeroed (what
    the JAX kernel is given)."""
    rng = np.random.RandomState(seed)
    need = [-(-k // page_len) for k in kv]
    P = 1 + sum(need) + 3
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, m), np.int32)
    pools = [rng.randn(P, n, page_len, D).astype(np.float32)
             for _ in range(2)]
    used = 0
    for b in range(B):
        tables[b, :need[b]] = ids[used:used + need[b]]
        used += need[b]
        if need[b] and kv[b] % page_len:
            for pool in pools:
                pool[tables[b, need[b] - 1], :, kv[b] % page_len:] = np.nan
    for pool in pools:
        pool[0] = np.nan
    q = rng.randn(B, n, 1, D).astype(np.float32)
    live = (np.arange(m * page_len)[None] < np.asarray(kv)[:, None])
    views = [np.where(live[:, None, :, None],
                      pool[tables].transpose(0, 2, 1, 3, 4).reshape(
                          B, n, m * page_len, D), 0.0).astype(np.float32)
             for pool in pools]
    return q, pools[0], pools[1], tables, np.asarray(kv, np.int32), views


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port(fn, q, kp, vp, tables, page_len, kv):
    o, lse = fn(*_t(q, kp, vp, tables), page_len, *_t(kv, kv - 1))
    return o.numpy(), lse.numpy()


CASES = [
    # page_len 1: a page edge at every key; the split's 32-key edges
    (1, 40, [0, 1, 2, 31, 32, 33, 40]),
    # page_len 4: kv 0, 1, either side of page edges, the whole view
    (4, 10, [0, 1, 3, 4, 5, 8, 9, 40]),
    # the engine's geometry (page_len 16, 24 pages) and its page edges
    (16, 24, [384, 1, 17, 15, 16, 250, 100, 64, 333, 5, 0]),
    # part edges: 2 and 4 parts of 32 keys either side, then 4 longer
    (16, 20, [63, 64, 65, 127, 128, 129, 320]),
]


@pytest.mark.parametrize("page_len,m,kv", CASES)
@pytest.mark.parametrize("which", ["plain", "split"])
def test_decode_plain_versions_match_jax_k1_interpret(page_len, m, kv,
                                                      which):
    B, n, D = len(kv), 2, 16
    q, kp, vp, tables, lens, (vk, vv) = _paged(B, n, D, page_len, m, kv,
                                               seed=page_len * 7 + m)
    ref_o, ref_lse = pal.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(vk), jnp.asarray(vv), causal=False,
        kv_len=jnp.asarray(lens), block_q=8, block_k=64, interpret=True)
    fn = {"plain": fa.flash_attn_decode_plain,
          "split": fa.flash_attn_decode_split_plain}[which]
    o, lse = _port(fn, q, kp, vp, tables, page_len, lens)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(o, np.asarray(ref_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)
    for b, n_live in enumerate(kv):
        if n_live == 0:   # fully masked rows: O = 0, LSE = -1e30 (K1)
            assert np.abs(o[b]).max() == 0.0
            assert np.all(lse[b] == np.float32(fa.NEG))


@pytest.mark.parametrize("page_len,m,kv", CASES[2:])
def test_split_plain_row_alone_equals_row_in_the_batch(page_len, m, kv):
    """The split depends on each row's own length: a row's O and LSE
    bits are the same computed alone as in the batch."""
    B = len(kv)
    q, kp, vp, tables, lens, _ = _paged(B, 3, 8, page_len, m, kv, seed=9)
    q, kp, vp, tables, lens = _t(q, kp, vp, tables, lens)
    o, lse = fa.flash_attn_decode_split_plain(q, kp, vp, tables, page_len,
                                              lens, lens - 1)
    for b in range(B):
        s = slice(b, b + 1)
        ob, lseb = fa.flash_attn_decode_split_plain(
            q[s], kp, vp, tables[s], page_len, lens[s], lens[s] - 1)
        assert torch.equal(ob[0], o[b]) and torch.equal(lseb[0], lse[b])


def test_split_constants_match_the_kernel_source():
    """`decode_parts` cuts a row as the kernel does only while its
    constants equal the kernel's kDecRanks and kDecMinKeys."""
    src = (Path(fa.__file__).parent.parent / "csrc"
           / "flash_attn_fwd.cu").read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
           for name in ("kDecRanks", "kDecMinKeys")}
    assert got == {"kDecRanks": fa.DECODE_RANKS,
                   "kDecMinKeys": fa.DECODE_MIN_KEYS}


@pytest.mark.parametrize("lim", [0, 1, 31, 32, 33, 63, 64, 65, 127, 128,
                                 129, 300, 384, 1024, 1025])
def test_decode_parts_cover_the_row_in_order(lim):
    parts = fa.decode_parts(lim)
    assert 1 <= len(parts) <= fa.DECODE_RANKS
    assert parts[0][0] == 0 and parts[-1][1] == lim
    for (a0, a1), (b0, _) in zip(parts, parts[1:]):
        assert a1 == b0 and a1 > a0          # contiguous, none empty
    if lim:
        assert len(parts) == min(fa.DECODE_RANKS,
                                 -(-lim // fa.DECODE_MIN_KEYS))
        sizes = [k1 - k0 for k0, k1 in parts]
        assert max(sizes) == -(-lim // len(parts)) and min(sizes) > 0


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    q, kp, vp, tables, lens, _ = _paged(3, 2, 16, 4, 6, [24, 5, 0], seed=2)
    before = fa.flash_attn_fwd.launches
    o, lse = _port(fa.flash_attn_decode, q, kp, vp, tables, 4, lens)
    ref_o, ref_lse = _port(fa.flash_attn_decode_plain, q, kp, vp, tables, 4,
                           lens)
    assert fa.flash_attn_fwd.launches == before
    assert np.array_equal(o, ref_o) and np.array_equal(lse, ref_lse)
    assert o.shape == (3, 2, 1, 16) and lse.shape == (3, 2, 1)


def test_meta_tensors_give_shapes_only():
    q = torch.empty(3, 2, 1, 16, device="meta")
    kp = torch.empty(7, 2, 4, 16, device="meta")
    tables = torch.empty(3, 5, dtype=torch.int32, device="meta")
    lens = torch.empty(3, dtype=torch.int32, device="meta")
    o, lse = fa.flash_attn_decode(q, kp, kp, tables, 4, lens, lens)
    assert o.shape == (3, 2, 1, 16) and o.device.type == "meta"
    assert lse.shape == (3, 2, 1) and lse.dtype == torch.float32


def test_wrapper_rejects_mismatched_operands_and_short_tables():
    q, kp, vp, tables, lens, _ = _paged(2, 2, 16, 4, 3, [5, 12], seed=4)
    q, kp, vp, tables, lens = _t(q, kp, vp, tables, lens)
    with pytest.raises(ValueError, match=r"\[B, n, 1, D\]"):
        fa.flash_attn_decode(q.expand(2, 2, 3, 16), kp, vp, tables, 4,
                             lens, lens - 1)
    with pytest.raises(ValueError, match="page_len"):
        fa.flash_attn_decode(q, kp, vp, tables, 8, lens, lens - 1)
    with pytest.raises(ValueError, match="tables"):
        fa.flash_attn_decode(q, kp, vp, tables[:1], 4, lens, lens - 1)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attn_decode(q, kp, vp, tables, 4, lens[:1], lens - 1)
    with pytest.raises(ValueError, match="tables"):
        fa.flash_attn_decode(q, kp, vp, tables[0], 4, lens, lens - 1)


def test_short_table_clamps_each_row_to_the_keys_it_covers():
    """A table shorter than kv_len is not refused (that would read
    kv_len back from the card): every device attends to the m *
    page_len keys the table covers, as flash_attn_fwd clamps kv_len to
    Tk. The card's test holds the kernel to the same contract."""
    q, kp, vp, tables, lens, views = _paged(2, 2, 16, 4, 3, [5, 12],
                                            seed=4)
    q, kp, vp, tables, lens = _t(q, kp, vp, tables, lens)
    short = tables[:, :2].contiguous()                 # 8 keys; row 1 has 12
    o, lse = fa.flash_attn_decode(q, kp, vp, short, 4, lens, lens - 1)
    clamped = torch.clamp(lens, max=8)
    ref_o, ref_lse = fa.flash_attn_fwd_plain(
        q, *_t(views[0][:, :, :8], views[1][:, :, :8]), clamped,
        clamped - 1, True, 0.25)
    assert bool(torch.isfinite(o).all())
    assert float((o - ref_o).abs().max()) <= TOL
    assert float((lse - ref_lse).abs().max()) <= TOL


def test_paged_decode_step_gathers_no_page_view(monkeypatch):
    """The paged decode step attends through the tables (one decode
    entry a layer, no `_gather_pages`); the paged prefill still gathers
    K and V once a layer."""
    from paddle_tpu.serving.lm import LMSpec, init_lm_weights
    spec = LMSpec(vocab_size=31, hidden_size=16, num_layers=2, num_heads=2,
                  max_len=32)
    w = {k: torch.from_numpy(v) for k, v in init_lm_weights(spec,
                                                            seed=3).items()}
    head = (tuple(w[f"stack.{leaf}"] for leaf in PT._LEAVES), w["tok_emb"],
            w["pos_emb"], w["ln_f.w_0"], w["ln_f.w_1"], w["lm_head.w"], 2)
    gathers, decodes = [], []
    real_gather, real_decode = PT._gather_pages, PT.flash_attn_decode
    monkeypatch.setattr(PT, "_gather_pages",
                        lambda *a: gathers.append(1) or real_gather(*a))
    monkeypatch.setattr(PT, "flash_attn_decode",
                        lambda *a: decodes.append(1) or real_decode(*a))
    ck, cv = _t(*(np.random.RandomState(s).randn(2, 6, 2, 4, 8).astype(
        np.float32) for s in (0, 1)))
    tables = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0]], dtype=torch.int32)
    PT.paged_decode_step(*head, ck, cv, *_t(np.array([5, 17], np.int32),
                                            np.array([6, 9], np.int32),
                                            np.array([True, True])), tables)
    assert (len(gathers), len(decodes)) == (0, spec.num_layers)
    toks = torch.tensor([[3, 7, 11], [1, 4, 0]], dtype=torch.int32)
    PT.paged_prefill(*head, ck, cv, toks, *_t(np.zeros(2, np.int32),
                                              np.array([3, 2], np.int32)),
                     tables)
    assert len(gathers) == 2 * spec.num_layers
