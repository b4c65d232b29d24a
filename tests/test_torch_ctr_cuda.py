"""The CTR path's SelectedRows gradients on the card (the twin of
chip_smoke.py's phase 32 (b)-(d), at a 200k-row table).

Marked `cuda`: they skip on a machine without a CUDA card. This file
imports neither JAX nor the JAX package, so on a card machine it runs
alone:

    python -m pytest --noconftest tests/test_torch_ctr_cuda.py

  * (b) wide&deep under SGD, `sparse_grad=selected_rows` against
    `dense` from one initialisation: losses and every parameter within
    rtol 1e-5, atol 1e-6 (tests/test_sparse.py's tolerance: the same
    math, the duplicate rows summed first instead of scattered);
  * (c) lazy Adam under selected_rows: rows no batch looked up keep
    their bits, the looked-up rows move;
  * (d) two selected_rows runs from one seed give the same bits in
    every state tensor (the merge sorts and sums in order: no atomics);
  * the merge itself on the card equals the CPU's: the same unique rows
    and padding, sums within 1e-6 of the largest;
  * the sparse update makes no device -> host sync.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch._device import use_full_f32
from paddle_tpu_torch.selected_rows import SelectedRows, merge_rows

pytestmark = pytest.mark.cuda

V, F, DIM, HIDDEN, B = 200_000, 26, 32, (64, 32), 4096


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_full_f32()
    pt.flags.reset()
    yield
    pt.flags.reset()


def _program(make_opt):
    pt.framework.reset_default_programs()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", [F, 1], dtype="int64")
        label = pt.layers.data("label", [1], dtype="float32")
        logit = pt.models.ctr.wide_deep(ids, V, F, emb_dim=DIM,
                                        hidden=HIDDEN, is_sparse=True)
        cost = pt.layers.mean(
            pt.layers.sigmoid_cross_entropy_with_logits(logit, label))
        make_opt().minimize(cost)
    return main, startup, cost


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, V, (B, F, 1)).astype(np.int64),
             "label": rng.randint(0, 2, (B, 1)).astype(np.float32)}
            for _ in range(n)]


def _train(mode, make_opt, feeds, init=None):
    """(losses, {name: tensor} after training) under `sparse_grad=mode`,
    from the startup program's state or a copy of `init`."""
    pt.flags.set_flag("sparse_grad", mode)
    main, startup, cost = _program(make_opt)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        for n, t in init.items():
            scope.set(n, t.clone())
    start = {n: t.clone() for n, t in scope.vars.items()
             if isinstance(t, torch.Tensor)}
    losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                            scope=scope)[0][0]) for f in feeds]
    return losses, start, {n: t for n, t in scope.vars.items()
                           if isinstance(t, torch.Tensor)}


def test_selected_rows_equals_dense_under_sgd(card):
    feeds = _feeds(3)
    sgd = lambda: pt.SGDOptimizer(0.5)   # noqa: E731
    d_losses, init, dense = _train("dense", sgd, feeds)
    s_losses, _, sparse = _train("selected_rows", sgd, feeds, init)
    np.testing.assert_allclose(s_losses, d_losses, rtol=1e-5, atol=1e-6)
    for n, t in dense.items():
        torch.testing.assert_close(sparse[n], t, rtol=1e-5, atol=1e-6,
                                   msg=n)


def test_lazy_adam_leaves_untouched_rows_and_repeats_bitwise(card):
    feeds = _feeds(3, seed=1)
    adam = lambda: pt.AdamOptimizer(1e-3)   # noqa: E731
    losses, start, a = _train("selected_rows", adam, feeds)
    _, _, b = _train("selected_rows", adam, feeds)
    for n, t in a.items():
        assert torch.equal(t, b[n]), n
    touched = torch.zeros(V, dtype=torch.bool, device="cuda")
    for f in feeds:
        touched[torch.from_numpy(f["ids"]).reshape(-1).cuda()] = True
    for name in ("deep_emb", "wide_emb"):
        assert torch.equal(a[name][~touched], start[name][~touched]), name
        assert bool((a[name][touched] != start[name][touched]).any())
    assert all(np.isfinite(losses))


def test_merge_on_the_card_equals_the_cpu(card):
    rng = np.random.RandomState(2)
    rows = rng.randint(0, 5000, B * F).astype(np.int32)
    vals = rng.randn(B * F, DIM).astype(np.float32)
    cpu = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), V)
    uniq_c, sum_c = merge_rows(cpu)
    uniq_g, sum_g = merge_rows(cpu.to("cuda"))
    assert torch.equal(uniq_g.cpu(), uniq_c)
    err = float((sum_g.cpu() - sum_c).abs().max())
    assert err <= 1e-6 * float(sum_c.abs().max()), err
    assert torch.equal(cpu.to("cuda").to_dense().cpu(), cpu.to_dense())


def test_sparse_update_makes_no_host_sync(card):
    """An Adam step on a SelectedRows gradient with duplicates, run
    under torch's sync debug mode set to raise."""
    from paddle_tpu_torch.ops import registry
    rng = np.random.RandomState(3)
    g = SelectedRows(
        torch.from_numpy(rng.randint(0, 1000, 4096).astype(np.int32)).cuda(),
        torch.randn(4096, DIM, device="cuda"), V)
    ins = {"Param": [torch.randn(V, DIM, device="cuda")],
           "Moment1": [torch.zeros(V, DIM, device="cuda")],
           "Moment2": [torch.zeros(V, DIM, device="cuda")],
           "Beta1Pow": [torch.full((1,), 0.9, device="cuda")],
           "Beta2Pow": [torch.full((1,), 0.999, device="cuda")],
           "LearningRate": [torch.full((1,), 1e-3, device="cuda")],
           "Grad": [g]}
    ctx = type("Ctx", (), {"in_place": True, "op": None})()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        registry.get_op("adam").lowering(ctx, ins, {})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
