"""Layer DSL: fluid.layers-shaped functions building the Program IR —
the port's copy of the layers its programs call."""

from .io import *        # noqa: F401,F403
from .tensor import *    # noqa: F401,F403
from .nn import *        # noqa: F401,F403
from .math_ops import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .rnn_group import *  # noqa: F401,F403
