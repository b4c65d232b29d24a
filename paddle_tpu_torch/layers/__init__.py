"""Layer DSL: fluid.layers-shaped functions building the Program IR —
the port's copy of the layers the GPT-2 training program calls."""

from .io import *        # noqa: F401,F403
from .tensor import *    # noqa: F401,F403
from .nn import *        # noqa: F401,F403
from .math_ops import *  # noqa: F401,F403
