"""Native (C++) host-side pieces of the port: recordio.cpp, built with
g++ at first use by build.py and loaded through ctypes by
paddle_tpu_torch.recordio."""

from . import build  # noqa: F401
