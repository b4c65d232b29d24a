"""The golden cases of the reference's oracle files, run on the port.

Every `OpTest` case of tests/test_tensor_manipulation_ops.py,
test_reduce_ops.py, test_elementwise_ops.py, test_op_tail.py,
test_loss_norm_ops.py and test_vision_op_tail.py (each parametrized
value a case of its own) runs unedited through op_test's harness
pointed at the port (`torch_op_test.port_op_test`): the one-op Program
built with the port's framework and run by the port's Executor on the
CPU, its outputs against the file's numpy goldens and its gradients
against central finite differences, with op_test's own tolerances.
"""

import pytest

import op_test
from torch_op_test import golden_cases, load_oracle, port_op_test
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ORACLES = ("test_tensor_manipulation_ops", "test_reduce_ops",
           "test_elementwise_ops", "test_op_tail", "test_loss_norm_ops",
           "test_vision_op_tail")

MODULES = {m: load_oracle(m) for m in ORACLES}
CASES = [c for m in ORACLES for c in golden_cases(MODULES[m])]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_golden_case_on_the_port(case):
    _, fn, kwargs = case
    before = len(op_test.RUN_LOG)
    with port_op_test():
        fn(**kwargs)
    ran = op_test.RUN_LOG[before:]
    assert ran and all(ok for _, _, ok in ran)


def test_every_oracle_file_contributes_cases():
    """Each oracle module gives cases: 100 in all."""
    for m in ORACLES:
        assert golden_cases(MODULES[m]), m
    assert len(CASES) == 100
