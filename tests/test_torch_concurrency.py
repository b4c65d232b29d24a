"""The port's CSP channels (`paddle_tpu_torch/concurrency.py`): every
scenario of tests/test_concurrency.py, run on the port. The file is
loaded as a private copy whose import names the port's module, so each
scenario is the reference test's own code; each runs on a thread of its
own under a 30 s limit, so a hang fails instead of eating the suite's
clock. Also: the port's channel API is the JAX package's, and the top
level exports `make_channel` / `close_channel` as the reference's does.
"""

import inspect
import os
import threading
import types

import pytest

import paddle_tpu
import paddle_tpu.concurrency as jconc
import paddle_tpu_torch
import paddle_tpu_torch.concurrency as pconc

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT_S = 30.0
_IMPORT = "from paddle_tpu.concurrency import"


def _port_copy():
    path = os.path.join(HERE, "test_concurrency.py")
    src = open(path).read()
    assert src.count(_IMPORT) == 1
    mod = types.ModuleType("_port_test_concurrency")
    mod.__file__ = path
    exec(compile(src.replace(_IMPORT, "from paddle_tpu_torch.concurrency "
                             "import"), path, "exec"), mod.__dict__)
    return mod


_COPY = _port_copy()
CASES = []
for _name, _fn in sorted(vars(_COPY).items()):
    if _name.startswith("test_") and callable(_fn):
        if "cap" in inspect.signature(_fn).parameters:
            CASES += [(_name, {"cap": cap}) for cap in (0, 10)]
        else:
            CASES.append((_name, {}))


def _within_limit(fn, kwargs):
    errors = []

    def body():
        try:
            fn(**kwargs)
        except BaseException as e:     # re-raised on the test's thread
            errors.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        pytest.fail(f"hung for {LIMIT_S} s")
    if errors:
        raise errors[0]


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[n + "".join(f"[{v}]" for v in k.values())
                              for n, k in CASES])
def test_reference_scenario_on_the_port(name, kwargs):
    fn = getattr(_COPY, name)
    assert fn.__globals__["make_channel"] is pconc.make_channel
    _within_limit(fn, kwargs)


def test_every_reference_scenario_is_run():
    names = {n for n, _ in CASES}
    assert len(names) == 10
    assert names == {n for n in dir(_COPY) if n.startswith("test_")}


def test_the_api_is_the_reference_s():
    assert pconc.__all__ == jconc.__all__
    for name in pconc.__all__:
        p, j = getattr(pconc, name), getattr(jconc, name)
        if inspect.isfunction(p):
            assert inspect.signature(p) == inspect.signature(j)
    assert paddle_tpu_torch.make_channel is pconc.make_channel
    assert paddle_tpu_torch.close_channel is pconc.close_channel
    assert paddle_tpu.make_channel is jconc.make_channel
    with pytest.raises(ValueError):
        pconc.make_channel(-1)
    with pytest.raises(ValueError):
        pconc._Buffered(0)
