"""Dataset package (the port's copy of `paddle_tpu/dataset/`): the
loaders the legacy front end's paths read, mnist and cifar, each a
creator returning an example-tuple generator compatible with
`reader.batch` / `DataFeeder`. The synthetic mode is the default (see
common.py); its draws come from `common.synthetic_rng`, so the samples
equal the JAX package's bit for bit. The reference's other eleven
loaders are not ported yet.
"""

from . import common       # noqa: F401
from . import mnist        # noqa: F401
from . import cifar        # noqa: F401

__all__ = ["common", "mnist", "cifar"]
