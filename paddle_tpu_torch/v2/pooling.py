"""v2 pooling objects (reference python/paddle/v2/pooling.py)."""

__all__ = ["Max", "Avg", "Sum", "CudnnMax", "CudnnAvg"]


class _Pool:
    def __repr__(self):
        return f"pooling.{type(self).__name__}()"


class Max(_Pool):
    pass


class Avg(_Pool):
    pass


class Sum(_Pool):
    pass


# cudnn variants are the same pooling on this backend
CudnnMax = Max
CudnnAvg = Avg
