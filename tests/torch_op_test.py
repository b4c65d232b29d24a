"""A port-side twin of tests/op_test.py's `OpTest`.

`port_op_test()` points op_test's harness at `paddle_tpu_torch`: while
it is active, an `OpTest` case builds its one-op Program with the port's
framework, runs it through the port's Executor on the CPU, and checks
its gradients with the port's `calc_gradient` against central finite
differences, with op_test's own tolerances. op_test.py itself is not
changed; the golden cases of the reference's oracle files run unedited.

`load_oracle(name)` imports a private copy of an oracle module (its
module-level random state apart from the copy pytest runs), and
`golden_cases(module)` lists the cases of an oracle module: each
`test_*` function that builds an `OpTest` and checks it through the
harness, once for each of its parametrized values, as `(id, fn,
kwargs)`. A function that runs the JAX package's Executor itself
(`import paddle_tpu` in its body) is no harness case and is left out.
"""

import contextlib
import importlib.util
import inspect
import itertools
import os

import op_test
import paddle_tpu_torch
from paddle_tpu_torch import backward as port_backward
from paddle_tpu_torch import framework as port_framework


@contextlib.contextmanager
def port_op_test():
    """op_test's harness on the port while the context is active."""
    saved = (op_test.pt, op_test.framework, op_test.calc_gradient,
             op_test.TPU_MODE)
    op_test.pt = paddle_tpu_torch
    op_test.framework = port_framework
    op_test.calc_gradient = port_backward.calc_gradient
    op_test.TPU_MODE = False
    try:
        yield
    finally:
        (op_test.pt, op_test.framework, op_test.calc_gradient,
         op_test.TPU_MODE) = saved


def load_oracle(name):
    """A fresh copy of tests/<name>.py under another module name: its
    cases draw from their own module-level generators, so the file's
    own run sees the inputs it always saw."""
    path = os.path.join(os.path.dirname(op_test.__file__), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_golden_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _param_sets(fn):
    """The keyword sets of fn's pytest.mark.parametrize marks (one set of
    {} when it has none)."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        if len(names) == 1:
            values = [(v,) for v in values]
        axes.append([dict(zip(names, v)) for v in values])
    sets = []
    for combo in itertools.product(*axes):
        kw = {}
        for d in combo:
            kw.update(d)
        sets.append(kw)
    return sets or [{}]


def golden_cases(module):
    cases = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        src = inspect.getsource(fn)
        if "OpTest" not in src or "import paddle_tpu" in src:
            continue
        for kw in _param_sets(fn):
            suffix = "-".join(str(v) for v in kw.values())
            mod = module.__name__.replace("port_golden_", "")
            cases.append((f"{mod}::{name}"
                          + (f"[{suffix}]" if suffix else ""), fn, kw))
    return cases
