"""The sequence lowerings on the card against the port on the CPU, at
the width of chip_smoke.py's phase 28 (emb / hid 512, vocab 30000).

Marked `cuda`: they skip on a machine without a CUDA card. This file
imports neither JAX nor the JAX package, so on a card machine it runs
alone:

    python -m pytest --noconftest tests/test_torch_sequence_cuda.py

  * gru and lstm (both directions, ragged lengths with a zero-length
    row), forward and the gradients of every float input, f32 with TF32
    off: within 1e-4 of each output's largest element;
  * gru_attention_beam_decode (beam 4, max_len 8) on the same encoder
    states and weights: ids and lengths equal on every row but one where
    some step's chosen candidate led the next by under 1e-5 (there, a
    rounding difference may pick the other candidate); scores within
    1e-4 relative on every row whose sentences are equal.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch._device import use_full_f32
from paddle_tpu_torch.ops import beam_ops
from paddle_tpu_torch.ops import registry
from torch_port_helpers import rel_err

pytestmark = pytest.mark.cuda

W, V = 512, 30000
REL = 1e-4
TIE_LEAD = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_full_f32()
    return torch.device("cuda", torch.cuda.current_device())


class _Ctx:
    is_test = False
    amp_dtype = None
    generator = None
    op = None
    in_place = False


def _lowered(op, ins, attrs, slots, grad, device, cot_seed=0):
    """Outputs of `slots` and the gradients of their sum against seeded
    cotangents w.r.t. the `grad` inputs, on `device`."""
    ctx = _Ctx()
    ctx.device = device
    leaves = {k: [torch.from_numpy(v).to(device) for v in vs]
              for k, vs in ins.items()}
    for k in grad:
        leaves[k][0].requires_grad_(True)
    out = registry.get_op(op).lowering(ctx, leaves, dict(attrs))
    ys = [out[s][0] for s in slots]
    rng = np.random.RandomState(cot_seed)
    cots = [torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
            .to(device) for y in ys]
    gs = torch.autograd.grad(ys, [leaves[k][0] for k in grad], cots)
    return [y.detach().cpu() for y in ys], [g.cpu() for g in gs]


def _u(rng, *shape, s=0.1):
    return rng.uniform(-s, s, shape).astype(np.float32)


@pytest.mark.parametrize("op", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_recurrence_on_the_card_matches_the_cpu(card, op, reverse):
    rng = np.random.RandomState(1)
    B, T, g = 8, 16, 3 if op == "gru" else 4
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 0
    ins = {"Input": [_u(rng, B, T, g * W, s=1.0)],
           "Weight": [_u(rng, W, g * W, s=0.05)],
           "Bias": [_u(rng, 1, (7 if op == "lstm" else 3) * W)],
           "H0": [_u(rng, B, W, s=0.5)], "SeqLen": [lens]}
    attrs = {"is_reverse": reverse}
    slots = ["Hidden"]
    if op == "lstm":
        ins["C0"] = [_u(rng, B, W, s=0.5)]
        attrs["use_peepholes"] = True
        slots.append("Cell")
    grad = [k for k in ins if k != "SeqLen"]
    ref = _lowered(op, ins, attrs, slots, grad, torch.device("cpu"))
    got = _lowered(op, ins, attrs, slots, grad, card)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        assert rel_err(a, b) <= REL, rel_err(a, b)


def _leads(record):
    """beam_step wrapped to append each step's smallest lead among its
    K + 1 best candidates, row by row."""
    real = beam_ops.beam_step

    def step(pre, logp, fin, end_id, k, first_step=False):
        B, K, Vv = logp.shape
        cont = torch.where(fin[..., None],
                           torch.where(torch.arange(Vv) == end_id,
                                       torch.tensor(0.0),
                                       torch.tensor(-1e9)), logp)
        total = pre[..., None] + cont
        if first_step:
            total[:, 1:] += -1e9
        top = torch.sort(total.reshape(B, -1), dim=1, descending=True,
                         stable=True).values[:, :k + 1]
        record.append((top[:, :-1] - top[:, 1:]).amin(dim=1))
        return real(pre, logp, fin, end_id, k, first_step)
    return real, step


def test_beam_decode_on_the_card_matches_the_cpu(card):
    rng = np.random.RandomState(2)
    B, Ts, He, K, L = 4, 12, 2 * W, 4, 8
    mask = (np.arange(Ts)[None, :] < np.array([12, 7, 3, 9])[:, None]) \
        .astype(np.float32)
    enc = _u(rng, B, Ts, He, s=1.0)
    w = {"TgtEmb": _u(rng, V, W, s=0.5), "DecProjW": _u(rng, W, 3 * W),
         "DecProjB": _u(rng, 3 * W), "GruW": _u(rng, W, 3 * W),
         "GruB": _u(rng, 1, 3 * W), "AttQueryW": _u(rng, W, He),
         "AttCombineW": _u(rng, W + He, W), "AttCombineB": _u(rng, W),
         "OutW": _u(rng, W, V, s=0.5), "OutB": _u(rng, V)}

    def run(device):
        return beam_ops.gru_attention_beam_decode(
            torch.from_numpy(enc).to(device),
            torch.from_numpy(mask).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in w.items()},
            K, L, 1, 2)

    got = [t.cpu() for t in run(card)]
    record = []
    real, wrapped = _leads(record)
    beam_ops.beam_step = wrapped
    try:
        ref = run(torch.device("cpu"))
    finally:
        beam_ops.beam_step = real
    near = torch.stack(record).amin(0) < TIE_LEAD
    same = (got[0] == ref[0]).flatten(1).all(1) & (got[2] == ref[2]).all(1)
    assert bool((same | near).all()), (same, near)
    rel = ((got[1] - ref[1]).abs() / ref[1].abs())[same]
    assert float(rel.max()) <= REL
