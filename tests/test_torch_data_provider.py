"""The `@provider` data path (`data_provider.py`) in the port against the
JAX package, on the CPU: the provider cases of
tests/test_provider_debug_rowconv.py and the rest of the input-type
vocabulary. Each case runs in both packages: the samples (values,
dtypes, shapes, nesting), the validation errors and the slots equal.
"""

import numpy as np
import pytest

from paddle_tpu import data_provider as jdp
from paddle_tpu_torch import data_provider as pdp


def _basic(dp):
    @dp.provider(input_types=[dp.dense_vector(3), dp.integer_value(10)])
    def process(settings, fname):
        for i in range(5):
            yield [i * 1.0] * 3, i
    return process


def _sequence_and_sparse(dp):
    @dp.provider(input_types=[dp.integer_value_sequence(100),
                              dp.sparse_binary_vector(8),
                              dp.sparse_float_vector(6),
                              dp.dense_vector_sequence(2)])
    def process(settings, f):
        yield [1, 2, 3], [0, 5], [(1, 0.5), (4, -2.0)], [[1, 2], [3, 4]]
        yield [7], [], [(0, 1.25)], [[0.5, 0.25]]
    return process


def _sub_sequence(dp):
    @dp.provider(input_types=[dp.integer_value_sub_sequence(10),
                              dp.dense_vector_sub_sequence(2),
                              dp.sparse_binary_vector_sequence(4),
                              dp.sparse_float_vector_sequence(3)])
    def process(settings, f):
        yield ([[1, 2], [3]], [[[0, 1]], [[2, 3], [4, 5]]], [[0], [1, 3]],
               [[(2, 0.5)]])
    return process


def _init_hook(dp):
    """Slots set by an init_hook from the data source's args (the
    benchmark providers' style); a hook without **kwargs gets only the
    names it declares."""
    def hook(settings, dim, num_samples):
        settings.dim = dim
        settings.num_samples = num_samples
        settings.slots = [dp.dense_vector(dim), dp.integer_value(2)]

    @dp.provider(init_hook=hook, cache=dp.CacheType.CACHE_PASS_IN_MEM)
    def process(settings, file_list):
        rng = np.random.RandomState(3)
        for _ in range(settings.num_samples):
            x = rng.randn(settings.dim)
            yield x, int(x.sum() > 0)
    return process.bind({"dim": 4, "num_samples": 6}, file_list=["a"],
                        is_train=True)


def _shuffled(dp):
    @dp.provider(input_types=[dp.integer_value(100)], should_shuffle=True,
                 pool_size=8)
    def process(settings, f):
        yield from range(20)
    return process


CASES = {"basic": _basic, "sequence_and_sparse": _sequence_and_sparse,
         "sub_sequence": _sub_sequence, "init_hook": _init_hook}


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_provider_samples_equal_the_reference(name):
    jprov, pprov = CASES[name](jdp), CASES[name](pdp)
    _same(list(pprov.reader("f")()), list(jprov.reader("f")()))
    _same(list(pprov.reader_from_list(["a", "b"])()),
          list(jprov.reader_from_list(["a", "b"])()))
    assert ([repr(t) for t in pprov.input_types]
            == [repr(t) for t in jprov.input_types])
    assert ([(t.kind, t.dim, t.seq) for t in pprov.settings.slots]
            == [(t.kind, t.dim, t.seq) for t in jprov.settings.slots])


def test_provider_shuffles_the_same_set():
    jrows = list(_shuffled(jdp).reader(None)())
    prows = list(_shuffled(pdp).reader(None)())
    assert sorted(prows) == sorted(jrows) == [(i,) for i in range(20)]


def _bad_cases(dp):
    @dp.provider(input_types=[dp.integer_value(3)])
    def out_of_range(settings, f):
        yield 7

    @dp.provider(input_types=[dp.dense_vector(4), dp.integer_value(2)])
    def wrong_arity(settings, f):
        yield [1.0] * 4

    @dp.provider(input_types=[dp.dense_vector(4)])
    def wrong_width(settings, f):
        yield [1.0] * 3

    @dp.provider(init_hook=lambda settings, **kw: None)
    def no_slots(settings, f):
        yield 1
    return {"out_of_range": lambda: list(out_of_range.reader(None)()),
            "wrong_arity": lambda: list(wrong_arity.reader(None)()),
            "wrong_width": lambda: list(wrong_width.reader(None)()),
            "no_slots": lambda: no_slots.bind({})}


@pytest.mark.parametrize("name", ["out_of_range", "wrong_arity",
                                  "wrong_width", "no_slots"])
def test_provider_validation_errors_equal_the_reference(name):
    msgs = []
    for dp in (jdp, pdp):
        with pytest.raises(ValueError) as e:
            _bad_cases(dp)[name]()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_provider_needs_input_types_or_a_hook():
    for dp in (jdp, pdp):
        with pytest.raises(ValueError, match="requires input_types"):
            dp.provider()
