"""The port's Hopper kernels on the card, held to their plain versions.

Marked `cuda`: they skip on a machine without a CUDA card (the kernels
have no interpret mode). This file imports neither JAX nor the JAX
package, so on a card machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa


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
def test_flash_attn_fwd_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 4, 48, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attn_fwd(q, q, q, lens, lens)
    q64 = torch.zeros(1, 2, 4, 64, device=card)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attn_fwd(q64.double(), q64.double(), q64.double(), lens,
                          lens)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attn_fwd(q64, q64, q64, lens.long(), lens.long())
