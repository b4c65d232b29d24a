"""v2 attribute objects (reference python/paddle/v2/attr.py)."""

from ..param_attr import ParamAttr

__all__ = ["Param", "ParamAttr", "Extra", "ExtraAttr"]

Param = ParamAttr


class Extra:
    """ExtraLayerAttribute: scheduling hints with no meaning here —
    accepted and ignored for config compatibility."""

    def __init__(self, **kwargs):
        self.attrs = kwargs


ExtraAttr = Extra
