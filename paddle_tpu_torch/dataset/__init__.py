"""Dataset package (the port's copy of `paddle_tpu/dataset/`): the 13
loaders of the reference (python/paddle/v2/dataset/: mnist, cifar,
imdb, imikolov, movielens, conll05, wmt14, wmt16, uci_housing, flowers,
voc2012, sentiment, mq2007) and common, each a creator returning an
example-tuple generator compatible with `reader.batch` / `DataFeeder`.
The synthetic mode is the default (see common.py); its draws come from
`common.synthetic_rng`, so the samples equal the JAX package's bit for
bit. Real mode parses files placed under DATA_HOME by hand (the port
downloads nothing); flowers and voc2012 import PIL (and scipy.io) only
there.
"""

from . import common       # noqa: F401
from . import mnist        # noqa: F401
from . import cifar        # noqa: F401
from . import imdb         # noqa: F401
from . import imikolov     # noqa: F401
from . import movielens    # noqa: F401
from . import conll05      # noqa: F401
from . import wmt14        # noqa: F401
from . import wmt16        # noqa: F401
from . import uci_housing  # noqa: F401
from . import flowers      # noqa: F401
from . import voc2012      # noqa: F401
from . import sentiment    # noqa: F401
from . import mq2007       # noqa: F401

__all__ = ["common", "mnist", "cifar", "imdb", "imikolov", "movielens",
           "conll05", "wmt14", "wmt16", "uci_housing", "flowers",
           "voc2012", "sentiment", "mq2007"]
