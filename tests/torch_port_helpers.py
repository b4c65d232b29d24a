"""Helpers shared by the port's image-model tests.

`one_torch_thread`: a fixture running torch's intra-op work in one
thread while a test runs. The tier-1 run puts several pytest workers on
the same cores, and each torch process starts one OpenMP thread a core:
the convolutions' thread teams then spin against each other's and a
test that takes seconds alone takes minutes.

`rel_err`: max |got - ref| / max |ref|, the measure the op-by-op
comparisons (`paddle_tpu_torch.executor.lower_ops_on`) are held to.

Neither imports JAX: the card-only tests use them too.
"""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, ref):
    """max |got - ref| / max |ref| (in float64)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)
