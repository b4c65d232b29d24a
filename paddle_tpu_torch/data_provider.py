"""PyDataProvider2-style `@provider` decorator (the port's copy of
`paddle_tpu/data_provider.py`; samples come out as the reference's do).

The legacy stack's data path (reference python/paddle/trainer/
PyDataProvider2.py:365 `provider`, C++ side PyDataProvider2.cpp:195):
a user function yielding one sample at a time, declared with typed
slots, shuffled through a pool and batched by the framework. Here the
decorator produces objects that plug directly into the pt.reader
decorator chain / DataFeeder instead of an embedded-CPython bridge.

Input types mirror the reference vocabulary (PyDataProvider2.py:109-215):
dense_vector, integer_value, sparse_binary_vector, sparse_float_vector,
each with a `_sequence` variant. Types validate/coerce each yielded
sample so malformed providers fail loudly at the source.
"""

from __future__ import annotations

import functools
import logging as _logging

import numpy as np

__all__ = [
    "provider", "dense_vector", "integer_value", "sparse_binary_vector",
    "sparse_float_vector", "dense_vector_sequence",
    "sparse_float_vector_sequence",
    "integer_value_sequence", "sparse_binary_vector_sequence",
    "integer_value_sub_sequence", "dense_vector_sub_sequence",
    "CacheType",
]


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class InputType:
    def __init__(self, kind, dim, seq=0):
        self.kind = kind
        self.dim = dim
        # nesting level: 0 scalar slot, 1 sequence, 2 sub-sequence
        # (the reference's SequenceType.{NO_SEQUENCE,SEQUENCE,SUB_SEQUENCE})
        self.seq = int(seq)

    def __repr__(self):
        return f"{self.kind}({self.dim}{', seq' * self.seq})"

    def convert(self, value):
        if self.seq >= 2:
            return [[self._one(v) for v in sub] for sub in value]
        if self.seq:
            return [self._one(v) for v in value]
        return self._one(value)

    def _one(self, v):
        if self.kind == "dense":
            arr = np.asarray(v, dtype=np.float32)
            if arr.shape != (self.dim,):
                raise ValueError(
                    f"dense_vector({self.dim}) got shape {arr.shape}")
            return arr
        if self.kind == "index":
            i = int(v)
            # value_range <= 1 means "unspecified" (the reference never
            # validates; its own benchmark provider declares
            # integer_value(1) while yielding 10 classes)
            if self.dim > 1 and not 0 <= i < self.dim:
                raise ValueError(
                    f"integer_value({self.dim}) got out-of-range {i}")
            return i
        # sparse kinds: list of ids (binary) / (id, value) pairs -> dense
        arr = np.zeros(self.dim, np.float32)
        if self.kind == "sparse_binary":
            for i in v:
                arr[int(i)] = 1.0
        else:
            for i, val in v:
                arr[int(i)] = float(val)
        return arr


def dense_vector(dim):
    return InputType("dense", dim)


def integer_value(value_range):
    return InputType("index", value_range)


def sparse_binary_vector(dim):
    return InputType("sparse_binary", dim)


def sparse_float_vector(dim):
    return InputType("sparse_float", dim)


def dense_vector_sequence(dim):
    return InputType("dense", dim, seq=1)


def integer_value_sequence(value_range):
    return InputType("index", value_range, seq=1)


def sparse_binary_vector_sequence(dim):
    return InputType("sparse_binary", dim, seq=1)


def sparse_float_vector_sequence(dim):
    return InputType("sparse_float", dim, seq=1)


def integer_value_sub_sequence(value_range):
    return InputType("index", value_range, seq=2)


def dense_vector_sub_sequence(dim):
    return InputType("dense", dim, seq=2)


class DataProvider:
    """The decorated object: call `.reader(obj)` (or the provider
    itself) to get a pt.reader-compatible creator over one input, or
    `.reader_from_list(objs)` to chain several (the file-list the
    reference trainer hands to PyDataProvider2).

    init_hook runs lazily on first use, receiving the
    define_py_data_sources2 `args` as kwargs — the reference's
    provider-instantiation contract (PyDataProvider2.py: the trainer
    creates the provider per data source and the hook may set
    settings.input_types / settings.slots when the decorator declared
    none). `bind(args)` applies the hook explicitly (the CLI path)."""

    def __init__(self, fn, input_types, should_shuffle, pool_size,
                 cache, init_hook):
        self.fn = fn
        self._decl_types = (list(input_types)
                            if input_types is not None else None)
        self.should_shuffle = bool(should_shuffle)
        self.pool_size = pool_size
        self.cache = cache
        self.init_hook = init_hook
        self._settings = None
        functools.update_wrapper(self, fn)

    def bind(self, args=None, file_list=None, is_train=True):
        """Return a NEW provider whose init_hook ran with the data
        source's args plus the reference-guaranteed kwargs
        (PyDataProvider2.py:495 passes file_list and is_train on top of
        the user args; hooks without **kwargs get only the names they
        declare). One decorated provider serves several data sources,
        each bound separately — the reference instantiates a provider
        per source."""
        import inspect
        bound = DataProvider(self.fn, self._decl_types,
                             self.should_shuffle, self.pool_size,
                             self.cache, self.init_hook)
        settings = _Settings(self._decl_types)
        if self.init_hook is not None:
            kwargs = dict(args or {})
            kwargs.setdefault("file_list", file_list)
            kwargs.setdefault("is_train", is_train)
            sig = inspect.signature(self.init_hook)
            if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values()):
                kwargs = {k: v for k, v in kwargs.items()
                          if k in sig.parameters}
            self.init_hook(settings, **kwargs)
        if settings.input_types is None:
            raise ValueError(
                f"provider {self.fn.__name__}: no input_types declared "
                "and init_hook did not set settings.slots")
        bound._settings = settings
        return bound

    @property
    def settings(self):
        if self._settings is None:
            self._settings = self.bind()._settings
        return self._settings

    @property
    def input_types(self):
        return self.settings.input_types

    def _convert(self, sample):
        if len(self.input_types) == 1 and not isinstance(sample, tuple):
            sample = (sample,)
        if len(sample) != len(self.input_types):
            raise ValueError(
                f"provider {self.fn.__name__} yielded {len(sample)} "
                f"slots, declared {len(self.input_types)}")
        return tuple(t.convert(v)
                     for t, v in zip(self.input_types, sample))

    def reader(self, obj=None):
        from . import reader as reader_mod

        def creator():
            for sample in self.fn(self.settings, obj):
                yield self._convert(sample)

        out = creator
        if self.cache == CacheType.CACHE_PASS_IN_MEM:
            out = reader_mod.cache(out)
        if self.should_shuffle:
            size = self.pool_size if self.pool_size > 0 else 1024
            out = reader_mod.shuffle(out, buf_size=size)
        return out

    def reader_from_list(self, objs):
        from . import reader as reader_mod
        return reader_mod.chain(*[self.reader(o) for o in objs])

    __call__ = reader


class _Settings:
    """The `settings` object handed to provider fns / init hooks
    (PyDataProvider2's settings: carries input_types + user state;
    `slots` is the reference's alias for input_types and hooks may
    assign either)."""

    def __init__(self, input_types):
        self.input_types = input_types
        self.logger = _logging.getLogger("paddle_tpu_torch.data_provider")

    @property
    def slots(self):
        return self.input_types

    @slots.setter
    def slots(self, value):
        self.input_types = list(value)


def provider(input_types=None, should_shuffle=False, pool_size=-1,
             cache=CacheType.NO_CACHE, init_hook=None, **_compat):
    """Decorator turning `fn(settings, obj) -> yields samples` into a
    DataProvider (reference PyDataProvider2.py:365). input_types may be
    omitted when an init_hook sets settings.slots (the reference
    benchmark providers do this). Unused legacy kwargs (min_pool_size,
    calc_batch_size, check...) are accepted and ignored for config
    compatibility."""
    if input_types is None and init_hook is None:
        raise ValueError("provider requires input_types (or an "
                         "init_hook that sets settings.slots)")

    def deco(fn):
        return DataProvider(fn, input_types, should_shuffle, pool_size,
                            cache, init_hook)
    return deco
