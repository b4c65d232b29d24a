"""The port's recurrences (paddle_tpu_torch/ops/rnn_ops.py, time loops of
torch ops) against the JAX package's `lax.scan` lowerings
(paddle_tpu/ops/rnn_ops.py) on the CPU: lstm, gru, simple_rnn, lstmp,
gru_unit and lstm_unit, forward and the gradients of every float input.

Each case has ragged lengths with a full row and a zero-length row, so
the padded steps carry the state (their outputs and gradients are the
carried state, not zero), and runs both directions: a reverse scan
carries h0 through a row's padded tail before its valid steps. H0 / C0,
peepholes, the int activation codes of gru_unit and the projection of
lstmp each get a case. The sizes are tests/test_rnn_op_suite.py's
(B 3, T 5, D 4).

Tolerances (tests/torch_parity_helpers.py): 1e-5 absolute on forward
values, 1e-4 of the largest reference element on gradients.
"""

import re

import numpy as np
import pytest

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as preg
from torch_parity_helpers import check_grads, check_outputs, run_both, uniform
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, D = 3, 5, 4
LENS = np.array([5, 2, 0], np.int32)


def test_every_reference_rnn_op_is_registered():
    import paddle_tpu.ops.rnn_ops as ref
    names = set(re.findall(r'register_op\("(\w+)"', open(ref.__file__).read()))
    assert names == {"lstm", "gru", "simple_rnn", "gru_unit", "lstm_unit",
                     "lstmp"}
    for n in names:
        assert preg.get_op(n).differentiable == jreg.get_op(n).differentiable


def _both_slots(op, ins, attrs, slots, grad):
    """Forward of every slot, and the gradients under a seeded cotangent
    on each of `slots` at once."""
    jout, pout, jg, pg = run_both(op, ins, attrs, out=tuple(slots),
                                  grad=grad)
    check_outputs(jout, pout)
    check_grads(jg, pg)
    return pout


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstm(peep, reverse):
    ins = {"Input": [uniform(1, (B, T, 4 * D))],
           "Weight": [uniform(2, (D, 4 * D), -.5, .5)],
           "Bias": [uniform(3, (1, 7 * D if peep else 4 * D), -.1, .1)],
           "SeqLen": [LENS]}
    grad = ("Input", "Weight", "Bias")
    if peep:        # with the initial states in the same case
        ins["H0"] = [uniform(4, (B, D))]
        ins["C0"] = [uniform(5, (B, D))]
        grad += ("H0", "C0")
    pout = _both_slots("lstm", ins, {"use_peepholes": peep,
                                     "is_reverse": reverse},
                       ("Hidden", "Cell"), grad)
    # the zero-length row carries its initial state at every step
    h0 = ins["H0"][0][2] if peep else np.zeros(D, np.float32)
    np.testing.assert_array_equal(pout["Hidden"][0][2].numpy(),
                                  np.broadcast_to(h0, (T, D)))


def test_lstm_activations():
    ins = {"Input": [uniform(6, (B, T, 4 * D))],
           "Weight": [uniform(7, (D, 4 * D), -.5, .5)],
           "SeqLen": [LENS]}
    _both_slots("lstm", ins, {"gate_activation": "sigmoid",
                              "cell_activation": "relu",
                              "candidate_activation": "identity"},
                ("Hidden",), ("Input", "Weight"))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_gru(reverse, h0):
    ins = {"Input": [uniform(8, (B, T, 3 * D))],
           "Weight": [uniform(9, (D, 3 * D), -.5, .5)],
           "Bias": [uniform(10, (1, 3 * D), -.1, .1)],
           "SeqLen": [LENS]}
    grad = ("Input", "Weight", "Bias")
    if h0:
        ins["H0"] = [uniform(11, (B, D))]
        grad += ("H0",)
    pout = _both_slots("gru", ins, {"is_reverse": reverse}, ("Hidden",),
                       grad)
    if reverse:
        # row 1 (len 2) reversed: the padded tail 2..4 holds h0, steps
        # 1 and 0 then run
        want = ins["H0"][0][1] if h0 else np.zeros(D, np.float32)
        np.testing.assert_array_equal(pout["Hidden"][0][1, 2:].numpy(),
                                      np.broadcast_to(want, (T - 2, D)))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_simple_rnn(reverse):
    ins = {"Input": [uniform(12, (B, T, D))],
           "Weight": [uniform(13, (D, D), -.5, .5)],
           "H0": [uniform(14, (B, D))], "SeqLen": [LENS]}
    _both_slots("simple_rnn", ins, {"is_reverse": reverse,
                                    "activation": "relu"},
                ("Hidden",), ("Input", "Weight", "H0"))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstmp(reverse):
    P = 3
    ins = {"Input": [uniform(15, (B, T, 4 * D))],
           "Weight": [uniform(16, (P, 4 * D), -.5, .5)],
           "ProjWeight": [uniform(17, (D, P), -.5, .5)],
           "Bias": [uniform(18, (1, 7 * D), -.1, .1)],
           "H0": [uniform(19, (B, D))], "C0": [uniform(20, (B, D))],
           "SeqLen": [LENS]}
    _both_slots("lstmp", ins, {"use_peepholes": True, "is_reverse": reverse},
                ("Projection", "Cell"),
                ("Input", "Weight", "ProjWeight", "Bias", "H0", "C0"))


@pytest.mark.parametrize("acts", [{}, {"gate_activation": 1,
                                       "activation": 3}],
                         ids=["names", "int-codes"])
def test_gru_unit(acts):
    ins = {"Input": [uniform(21, (B, 3 * D))],
           "HiddenPrev": [uniform(22, (B, D))],
           "Weight": [uniform(23, (D, 3 * D), -.5, .5)],
           "Bias": [uniform(24, (1, 3 * D), -.1, .1)]}
    _both_slots("gru_unit", ins, acts, ("Hidden", "Gate", "ResetHiddenPrev"),
                ("Input", "HiddenPrev", "Weight", "Bias"))


def test_lstm_unit():
    ins = {"X": [uniform(25, (B, 4 * D))], "C_prev": [uniform(26, (B, D))]}
    _both_slots("lstm_unit", ins, {"forget_bias": 0.5}, ("H", "C"),
                ("X", "C_prev"))
