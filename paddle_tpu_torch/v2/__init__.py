"""paddle.v2-shaped user API (the port's copy of `paddle_tpu/v2/`;
reference python/paddle/v2/__init__.py).

The legacy stack's training UX — layer DSL, activation/pooling/attr
objects, datasets, readers, SGD trainer with events, parameters,
inference — mapped onto the port's Program/Executor core (SURVEY §7.7:
translation over reimplementation). A v2-era script changes its import
line and runs.

Device: `init(use_gpu=None)` picks where `trainer.SGD`, `infer` /
`Inference` and `parameters.create` run unless they are given a place.
None or True means the CUDA card (raises when none is visible);
`use_gpu=False` is the caller asking for the CPU, as in Paddle.
"""

from . import _place
from . import activation        # noqa: F401
from . import attr              # noqa: F401
from . import data_type         # noqa: F401
from . import layer             # noqa: F401
from . import networks          # noqa: F401
from . import optimizer         # noqa: F401
from . import parameters       # noqa: F401
from . import pooling           # noqa: F401
from . import trainer           # noqa: F401
from .inference import infer, Inference  # noqa: F401
from . import plot             # noqa: F401
from . import image            # noqa: F401

from .. import event            # noqa: F401
from .. import dataset          # noqa: F401
from .. import reader           # noqa: F401
from ..reader import batch      # noqa: F401

__all__ = ["init", "layer", "activation", "attr", "data_type", "pooling",
           "networks", "optimizer", "parameters", "trainer", "event",
           "dataset", "reader", "batch", "infer", "Inference", "plot",
           "image"]


def init(use_gpu=None, trainer_count=1, **kwargs):
    """paddle.init analog: chooses the device (see the module docstring)
    and starts a fresh program state. The other legacy flags
    (trainer_count, log level...) are accepted so v2 scripts run."""
    from .. import framework
    from .. import executor as executor_mod
    _place.set_use_gpu(use_gpu)
    framework.reset_default_programs()
    executor_mod._global_scope = executor_mod.Scope()
    layer.reset_data_order()
