"""Legacy trainer_config_helpers vocabulary — config-file compatibility
(the port's copy of `paddle_tpu/trainer_config_helpers.py`).

The reference's legacy configs are Python scripts written against
`paddle.trainer_config_helpers` (reference python/paddle/
trainer_config_helpers/layers.py, ~150 wrappers) and compiled to
ModelConfig protos by config_parser.py (4.4k LoC). SURVEY §7.7's
strategy is translation: this module exposes the same NAMES — layer
functions (`*_layer`), activation/pooling/optimizer/regularization
objects, `settings`, `get_config_arg`, `define_py_data_sources2`,
`outputs` — but each call builds the port's Program IR directly, so an
unmodified reference config file executes via `parse_config` and yields
a program the port's Executor runs (on the card unless asked for the
CPU).

`parse_config` installs THIS package's `paddle` alias on every call, and
a config's provider module is imported against this package's
`data_provider`, even in a process that also holds the JAX package.

Typing note: legacy data layers get their element type from the DATA
PROVIDER declaration, not the config. Here `data_layer` returns a lazy
handle materialised by its first consumer — conv/fc treat it as a dense
vector, `embedding_layer` as an id sequence, cost labels as an integer
class — reproducing what provider types resolve in the reference.
"""

from __future__ import annotations

import math
import os

from . import layers as flayers
from . import optimizer as fopt
from .framework import default_main_program

__all__ = [
    # parse machinery
    "parse_config", "get_config_arg", "settings",
    "define_py_data_sources2", "outputs",
    # layers
    "data_layer", "fc_layer", "embedding_layer", "img_conv_layer",
    "img_pool_layer", "img_cmrnorm_layer", "img_conv_group",
    "conv_projection",
    "batch_norm_layer", "dropout_layer", "concat_layer", "addto_layer",
    "classification_cost", "cross_entropy", "regression_cost",
    "mse_cost", "last_seq", "first_seq", "simple_lstm", "max_id",
    # objects
    "ReluActivation", "SigmoidActivation", "TanhActivation",
    "SoftmaxActivation", "LinearActivation", "IdentityActivation",
    "MaxPooling", "AvgPooling", "SumPooling",
    "MomentumOptimizer", "AdamOptimizer", "AdaGradOptimizer",
    "ModelAverage",
    "RMSPropOptimizer",
    "L1Regularization", "L2Regularization",
    "ParamAttr", "ParameterAttribute", "ExtraAttr",
    "ExtraLayerAttribute",
]


# ---------------------------------------------------------------------------
# parse-time state
# ---------------------------------------------------------------------------

class _State:
    def __init__(self):
        self.config_args = {}
        self.settings = {}
        self.data_sources = None
        self.outputs = []
        self.data_layers = []   # _DataHandles in declaration order


_state = _State()


def get_config_arg(name, type_=str, default=None):
    """Command-line config args (reference config_parser
    get_config_arg; bool strings parsed like config_parser.py does —
    bool('False') must be False, not True)."""
    if name not in _state.config_args:
        return default
    v = _state.config_args[name]
    if isinstance(v, type_):
        return v
    if type_ is bool and isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0", ""):
            return False
        raise ValueError(f"config arg {name}={v!r} is not a bool")
    return type_(v)


def settings(batch_size=None, learning_rate=None, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             **kwargs):
    _state.settings.update(
        {k: v for k, v in dict(
            batch_size=batch_size, learning_rate=learning_rate,
            learning_method=learning_method, regularization=regularization,
            gradient_clipping_threshold=gradient_clipping_threshold,
            **kwargs).items() if v is not None})


def define_py_data_sources2(train_list, test_list, module, obj,
                            args=None):
    """Recorded, not imported: the provider pairing happens at training
    time via data_provider.provider / pt.reader (the embedded-CPython
    pull of PyDataProvider2.cpp:195 has no analog under jit)."""
    _state.data_sources = {"train_list": train_list,
                          "test_list": test_list, "module": module,
                          "obj": obj, "args": dict(args or {})}


def Inputs(*names):
    """Legacy Inputs(...) declaration: feed order is data-layer
    declaration order here; recorded for compatibility."""
    _state.settings["input_order"] = list(names)


def Outputs(*names):
    """Legacy Outputs(...): mark existing vars as the config outputs."""
    blk = default_main_program().global_block()
    for n in names:
        v = blk._find_var(n)
        if v is None and n == "__beam_search_predict__":
            # nested generation: the beam runs inside an outer group's
            # sub-block; the fetchable result is the group output the
            # seqtext printer was pointed at
            printers = _state.settings.get("seqtext_printers") or []
            for spec in reversed(printers):
                cand = _materialize_dense(spec["input"])
                if (getattr(cand, "name", None)
                        and blk._find_var(cand.name) is not None):
                    v = cand
                    break
        if v is None:
            raise KeyError(
                f"Outputs({n!r}): no variable of that name exists — "
                "legacy Outputs() takes exact var names (e.g. "
                "'__beam_search_predict__')")
        _state.outputs.append(v)


def seqtext_printer_evaluator(input, id_input=None, dict_file=None,
                              result_file=None, name=None, **_compat):
    """Recorded generation-printing spec (the reference evaluator
    writes decoded text at test time): ConfigRecord.write_generated_text
    (below) renders fetched ids through dict_file into result_file."""
    _state.settings.setdefault("seqtext_printers", []).append(
        {"input": input, "id_input": id_input, "dict_file": dict_file,
         "result_file": result_file})
    return input


def outputs(*layers):
    for l in layers:
        _state.outputs.append(_materialize_dense(l))


# ---------------------------------------------------------------------------
# activation / pooling / optimizer / attr objects
# ---------------------------------------------------------------------------

class _Act:
    op = None


def _mk_act(name, op):
    return type(name, (_Act,), {"op": op})


ReluActivation = _mk_act("ReluActivation", "relu")
SigmoidActivation = _mk_act("SigmoidActivation", "sigmoid")
TanhActivation = _mk_act("TanhActivation", "tanh")
SoftmaxActivation = _mk_act("SoftmaxActivation", "softmax")


class LinearActivation(_Act):
    op = None


IdentityActivation = LinearActivation


class MaxPooling:
    kind = "max"


class AvgPooling:
    kind = "avg"


class SumPooling:
    kind = "sum"   # sequence pooling only


class _OptSpec:
    def create(self, lr):
        raise NotImplementedError


class MomentumOptimizer(_OptSpec):
    def __init__(self, momentum=0.9):
        self.momentum = momentum

    def create(self, lr):
        return fopt.MomentumOptimizer(learning_rate=lr,
                                      momentum=self.momentum)


class AdamOptimizer(_OptSpec):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create(self, lr):
        return fopt.AdamOptimizer(learning_rate=lr, beta1=self.beta1,
                                  beta2=self.beta2, epsilon=self.epsilon)


class AdaGradOptimizer(_OptSpec):
    def create(self, lr):
        return fopt.AdagradOptimizer(learning_rate=lr)


class RMSPropOptimizer(_OptSpec):
    def create(self, lr):
        return fopt.RMSPropOptimizer(learning_rate=lr)


class ModelAverage:
    """settings(model_average=ModelAverage(average_window=0.5)) — the
    legacy spec for windowed parameter averaging (reference
    trainer_config_helpers/optimizers.py:319 / AverageOptimizer.h); the
    trainer materialises it as optimizer.ModelAverage after minimize()
    (ConfigRecord.create_model_average)."""

    def __init__(self, average_window=0.5, max_average_window=None,
                 do_average_in_cpu=False):
        self.average_window = float(average_window)
        self.max_average_window = max_average_window
        # storage placement hint only — irrelevant here (the
        # accumulators live wherever the params live)
        self.do_average_in_cpu = do_average_in_cpu


class L1Regularization:
    def __init__(self, rate):
        self.rate = rate


class L2Regularization:
    def __init__(self, rate):
        self.rate = rate


from .param_attr import ParamAttr  # noqa: E402

ParameterAttribute = ParamAttr


class ExtraAttr:
    def __init__(self, drop_rate=None, **kwargs):
        self.drop_rate = drop_rate
        self.attrs = kwargs


ExtraLayerAttribute = ExtraAttr


# ---------------------------------------------------------------------------
# lazy data layers
# ---------------------------------------------------------------------------

class _DataHandle:
    """Deferred data layer: the consumer decides the element type —
    refined by the data provider's slot declaration when the config's
    provider module is importable (reference semantics: the provider's
    input_types define sequence nesting, config_parser reads them)."""

    def __init__(self, name, size, height=None, width=None):
        self.name = name
        self.size = size
        self.height = height
        self.width = width
        self.var = None

    def _provider_seq_level(self):
        """0/1/2 from the provider's input_types for this data layer's
        slot position; None when the provider is not importable."""
        ds = _state.data_sources
        if not ds:
            return None
        try:
            idx = [h.name for h in _state.data_layers].index(self.name)
        except ValueError:
            return None
        types = _provider_input_types(ds)
        if types is None or idx >= len(types):
            return None
        return int(getattr(types[idx], "seq", 0))

    def as_dense(self):
        if self.var is None:
            self.var = flayers.data(name=self.name, shape=[self.size],
                                    dtype="float32")
        return self.var

    def as_label(self):
        if self.var is None:
            self.var = flayers.data(name=self.name, shape=[1],
                                    dtype="int64")
        return self.var

    def as_id_sequence(self):
        if self.var is None:
            level = self._provider_seq_level()
            self.var = flayers.data(name=self.name, shape=[1],
                                    dtype="int64",
                                    lod_level=2 if level == 2 else 1)
            self.var._v2_value_range = self.size
        return self.var

    def as_id_subsequence(self):
        if self.var is None:
            self.var = flayers.data(name=self.name, shape=[1],
                                    dtype="int64", lod_level=2)
            self.var._v2_value_range = self.size
        return self.var


def _provider_input_types(ds):
    """Import the config's data-provider module (best effort: cwd and
    the train_list's directory, where reference configs keep it) and
    return the named provider's input_types."""
    key = (ds.get("module"), ds.get("obj"))
    cache = _state.__dict__.setdefault("_provider_types_cache", {})
    if key in cache:
        return cache[key]
    result = None
    paths = [os.getcwd()]
    if ds.get("train_list"):
        paths.append(os.path.dirname(os.path.abspath(ds["train_list"])))
    for p in paths:
        try:
            mod = import_provider_module(ds["module"], p)
            prov = getattr(mod, ds["obj"])
            result = prov.bind(ds.get("args")).input_types
            break
        except Exception:
            continue
    cache[key] = result
    return result


def import_provider_module(name, directory):
    """Import the provider module `name` from `directory` against this
    package's data_provider, and leave `sys.modules` as it found it.

    A module of that name already in `sys.modules` may come from another
    config's directory (the reference test configs all call theirs
    'rnn_data_provider') or may have been imported under another
    package's `paddle` alias, bound to its data_provider: the module is
    executed afresh each time, under this package's alias, and the entry
    it displaced is put back."""
    import importlib
    import sys
    _install_paddle_alias()
    prev = sys.modules.pop(name, None)
    added = directory not in sys.path
    if added:
        sys.path.insert(0, directory)
    try:
        mod = importlib.import_module(name)
    finally:
        if added:
            sys.path.remove(directory)
        if prev is not None:
            sys.modules[name] = prev
        else:
            sys.modules.pop(name, None)
    mod.__dict__.setdefault("xrange", range)   # py2-era providers
    return mod


def _materialize_dense(x):
    return x.as_dense() if isinstance(x, _DataHandle) else x


def _act_op(act):
    return getattr(act, "op", None) if act is not None else None


def _act_op_or(act, default):
    """Activation name for recurrent-op attrs: None means 'use the
    op default'; an explicit LinearActivation/IdentityActivation means
    identity — not the default (act.op is None for both cases, so the
    distinction must be made on act itself)."""
    if act is None:
        return default
    return _act_op(act) or "identity"


def data_layer(name, size, height=None, width=None, **_compat):
    h = _DataHandle(name, size, height, width)
    _state.data_layers.append(h)
    return h


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def fc_layer(input, size, act=None, param_attr=None, bias_attr=None,
             layer_attr=None, name=None, **_compat):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    inputs = [_materialize_dense(v) for v in inputs]
    out = flayers.fc(inputs, size, act=_act_op(act),
                     param_attr=param_attr, bias_attr=bias_attr,
                     name=name)
    if isinstance(layer_attr, ExtraAttr) and layer_attr.drop_rate:
        out = flayers.dropout(out, dropout_prob=layer_attr.drop_rate)
    return out


def embedding_layer(input, size, param_attr=None, name=None, **_compat):
    sparse = bool(getattr(param_attr, "sparse_update", False))
    if isinstance(input, _DataHandle):
        ids = input.as_id_sequence()
        vocab = input.size
    elif getattr(input, "_v2_value_range", None):
        # an id variable whose vocab followed it (e.g. a recurrent_group
        # step slice of a data layer)
        ids = input
        vocab = input._v2_value_range
    else:
        raise TypeError("embedding_layer input must be a data_layer "
                        "(ids); got an intermediate layer")
    return flayers.embedding(ids, size=[vocab, size],
                             is_sparse=sparse,
                             param_attr=param_attr, name=name)


def _as_image(x, num_channels):
    """Reshape a flat data layer to NCHW like config_parser's conv
    inference: img_size = sqrt(size / channels)."""
    v = _materialize_dense(x)
    if len(v.shape or ()) == 4:
        return v
    if num_channels is None:
        raise ValueError("first img_* layer on flat input needs "
                         "num_channels")
    if isinstance(x, _DataHandle) and x.height:
        h, w = x.height, x.width
    else:
        hw = (v.shape[-1] if v.shape else 0) // num_channels
        side = int(math.isqrt(hw))
        if side * side != hw:
            raise ValueError(
                f"cannot infer square image from size {v.shape} with "
                f"{num_channels} channels (pass height/width to "
                "data_layer)")
        h = w = side
    from .layers import tensor as T
    out = T.reshape(v, [-1, num_channels, h, w])
    return out


def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, groups=1, act=None,
                   param_attr=None, bias_attr=None, name=None, **_compat):
    x = _as_image(input, num_channels)
    return flayers.conv2d(x, num_filters, filter_size, stride=stride,
                          padding=padding, groups=groups,
                          act=_act_op(act), param_attr=param_attr,
                          bias_attr=bias_attr, name=name)


def img_pool_layer(input, pool_size, stride=1, padding=0,
                   pool_type=None, name=None, **_compat):
    # reference default stride=1 (layers.py img_pool_layer) —
    # overlapping pooling when omitted, NOT stride=pool_size
    x = _materialize_dense(input)
    kind = "avg" if isinstance(pool_type, AvgPooling) else "max"
    # legacy pooling output size rounds UP (ceil); without it every
    # GoogLeNet/AlexNet-era config loses a pixel per pool and the
    # trailing 7x7 avgpool collapses to zero
    return flayers.pool2d(x, pool_size=pool_size, pool_type=kind,
                          pool_stride=stride,
                          pool_padding=padding, ceil_mode=True,
                          name=name)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, **kwargs):
    """Projection form of conv (mixed-layer plumbing in the reference);
    as a standalone call it is an unactivated conv — the CPU fallback
    the reference configs themselves use (googlenet.py:33)."""
    kwargs.pop("act", None)
    return img_conv_layer(input, filter_size, num_filters,
                          num_channels=num_channels, stride=stride,
                          padding=padding, act=None, **kwargs)


def img_cmrnorm_layer(input, size, scale=0.0001, power=0.75, name=None,
                      **_compat):
    return flayers.lrn(_materialize_dense(input), n=size, alpha=scale,
                       beta=power, name=name)


def img_conv_group(input, conv_num_filter, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, pool_size=2,
                   pool_stride=2, pool_type=None, **_compat):
    """Conv stack + pool (trainer_config_helpers networks.py
    img_conv_group — the VGG building block)."""
    x = _as_image(input, num_channels)
    bns = (conv_with_batchnorm if isinstance(conv_with_batchnorm, list)
           else [conv_with_batchnorm] * len(conv_num_filter))
    for nf, bn in zip(conv_num_filter, bns):
        x = flayers.conv2d(x, nf, conv_filter_size, padding=conv_padding,
                           act=None if bn else _act_op(conv_act))
        if bn:
            x = flayers.batch_norm(x, act=_act_op(conv_act))
    return img_pool_layer(x, pool_size, pool_stride,
                          pool_type=pool_type)


def batch_norm_layer(input, act=None, name=None, **_compat):
    return flayers.batch_norm(_materialize_dense(input),
                              act=_act_op(act), name=name)


def dropout_layer(input, dropout_rate, name=None):
    return flayers.dropout(_materialize_dense(input),
                           dropout_prob=dropout_rate, name=name)


def concat_layer(input, act=None, name=None, **_compat):
    vals = [_materialize_dense(v) for v in input]
    # legacy concat joins the FEATURE dimension: channels (axis 1) for
    # image [N,C,H,W] inputs (the inception-tower concat), last dim
    # otherwise
    axis = 1 if len(vals[0].shape or ()) == 4 else -1
    out = flayers.concat(vals, axis=axis, name=name)
    op = _act_op(act)
    if op:
        from .layer_helper import LayerHelper
        out = LayerHelper("concat", name=name).append_activation(out, op)
    return out


def addto_layer(input, act=None, name=None, **_compat):
    vals = [_materialize_dense(v) for v in input]
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    if act is not None and _act_op(act):
        from .layer_helper import LayerHelper
        helper = LayerHelper("addto", name=name)
        out = helper.append_activation(out, _act_op(act))
    return out


def last_seq(input, name=None, agg_level=None, **_compat):
    v = _materialize_dense(input)
    level = ("inner" if (v.lod_level >= 2 and agg_level == "seq")
             else "top")
    return flayers.sequence_last_step(v, name=name, level=level)


def first_seq(input, name=None, agg_level=None, **_compat):
    v = _materialize_dense(input)
    level = ("inner" if (v.lod_level >= 2 and agg_level == "seq")
             else "top")
    return flayers.sequence_first_step(v, name=name, level=level)


def simple_lstm(input, size, reverse=False, **_compat):
    from .v2 import networks as v2_networks
    return v2_networks.simple_lstm(_materialize_dense(input), size,
                                   reverse=reverse)


def max_id(input, name=None, **_compat):
    return flayers.argmax(_materialize_dense(input), axis=-1, name=name)


# -- costs ------------------------------------------------------------------

def _label_of(label):
    return label.as_label() if isinstance(label, _DataHandle) else label


def classification_cost(input, label, name=None, **_compat):
    v = _materialize_dense(input)
    lab = _label_of(label)
    if v.lod_level == 1 and len(v.shape) == 3:
        # cost over a SEQUENCE of predictions vs one label per sample
        # (legacy cost layers average per-position costs over the
        # sequence): the shared CE op broadcasts the [B,1] label over
        # time -> [B, T, 1]; masked sequence average -> scalar mean
        ce = flayers.squeeze(flayers.cross_entropy(v, lab), axes=[2])
        ce.lod_level = 1
        ce.seq_len_var = v.seq_len_var
        pooled = flayers.sequence_pool(ce, pool_type="average")
        return flayers.mean(pooled, name=name)
    return flayers.mean(flayers.cross_entropy(v, lab), name=name)


def cross_entropy(input, label, name=None, **_compat):
    return flayers.mean(flayers.cross_entropy(_materialize_dense(input),
                                              _label_of(label)),
                        name=name)


def regression_cost(input, label, name=None, **_compat):
    return flayers.mean(flayers.square_error_cost(
        _materialize_dense(input), _materialize_dense(label)), name=name)


mse_cost = regression_cost


# ---------------------------------------------------------------------------
# config execution
# ---------------------------------------------------------------------------

def _install_paddle_alias():
    """Legacy configs open with `from paddle.trainer_config_helpers
    import *`; alias that import path onto this module (only when no
    real `paddle` package exists in the environment). Any alias already
    installed, the JAX package's included, is replaced: a config parsed
    here builds into this package's programs and its provider binds this
    package's data_provider."""
    import sys
    import types

    if "paddle" in sys.modules and not getattr(
            sys.modules["paddle"], "__paddle_tpu_alias__", False):
        return
    if getattr(sys.modules.get("paddle"), "trainer_config_helpers",
               None) is sys.modules[__name__]:
        return
    from . import data_provider as dp_mod
    pkg = types.ModuleType("paddle")
    pkg.__paddle_tpu_alias__ = True
    pkg.trainer_config_helpers = sys.modules[__name__]
    trainer_pkg = types.ModuleType("paddle.trainer")
    trainer_pkg.PyDataProvider2 = dp_mod
    pkg.trainer = trainer_pkg
    sys.modules["paddle"] = pkg
    sys.modules["paddle.trainer"] = trainer_pkg
    # provider modules do `from paddle.trainer.PyDataProvider2 import *`
    sys.modules["paddle.trainer.PyDataProvider2"] = dp_mod
    sys.modules["paddle.trainer_config_helpers"] = sys.modules[__name__]


class ConfigRecord:
    """What a parsed legacy config produced."""

    def __init__(self, state):
        self.outputs = list(state.outputs)
        self.settings = dict(state.settings)
        self.data_sources = state.data_sources
        self.data_layers = list(state.data_layers)
        self.program = default_main_program()

    @property
    def feed_order(self):
        """Names of the data vars that were materialised, in config
        declaration order — the legacy contract binding provider slots
        to data layers (reference config input_order)."""
        return [h.name for h in self.data_layers if h.var is not None]

    def create_optimizer(self):
        """settings(learning_method=..., regularization=...,
        gradient_clipping_threshold=...) -> a framework optimizer with
        the regularizer and clipping mapped on."""
        method = self.settings.get("learning_method")
        lr = self.settings.get("learning_rate", 1e-3)
        opt = (fopt.SGDOptimizer(learning_rate=lr) if method is None
               else method.create(lr))
        reg = self.settings.get("regularization")
        if reg is not None:
            from . import regularizer as freg
            opt.regularization = (
                freg.L1DecayRegularizer(reg.rate)
                if isinstance(reg, L1Regularization)
                else freg.L2DecayRegularizer(reg.rate))
        clip = self.settings.get("gradient_clipping_threshold")
        if clip:
            from .clip import GradientClipByGlobalNorm
            opt.gradient_clip = GradientClipByGlobalNorm(clip)
        return opt

    def create_model_average(self, program=None):
        """settings(model_average=ModelAverage(...)) -> the framework's
        ModelAverage bound to `program` (call AFTER the optimizer's
        minimize), or None when averaging is off."""
        spec = self.settings.get("model_average")
        if spec is None or not spec.average_window:
            return None
        from .optimizer import ModelAverage as _FMA
        # 10000 is the reference's minAverageWindow default
        # (AverageOptimizer constructor)
        return _FMA(average_window_rate=spec.average_window,
                    min_average_window=10000,
                    max_average_window=(spec.max_average_window
                                        or 2 ** 31 - 1),
                    program=program)

    @property
    def batch_size(self):
        return self.settings.get("batch_size")

    def write_generated_text(self, ids, lens, result_file=None,
                             dict_file=None):
        """Render generated id sequences to text — the
        seqtext_printer_evaluator's output contract (reference
        gserver/evaluators printing ids through the word dict into
        result_file). ids [B, K, L], lens [B, K]."""
        import numpy as _np
        spec = (self.settings.get("seqtext_printers") or [{}])[0]
        dict_file = dict_file or spec.get("dict_file")
        result_file = result_file or spec.get("result_file")
        words = None
        if dict_file and os.path.exists(dict_file):
            words = [ln.split()[0] for ln in open(dict_file)
                     if ln.strip()]
        ids = _np.asarray(ids)
        lens = _np.asarray(lens)
        lines = []
        for b in range(ids.shape[0]):
            for k in range(ids.shape[1]):
                toks = ids[b, k, :int(lens[b, k])]
                text = " ".join(words[t] if words and t < len(words)
                                else str(int(t)) for t in toks)
                lines.append(f"{b}\t{k}\t{text}")
        out = "\n".join(lines) + "\n"
        if result_file:
            os.makedirs(os.path.dirname(os.path.abspath(result_file)),
                        exist_ok=True)
            with open(result_file, "w") as f:
                f.write(out)
        return out


def parse_config(path_or_source, config_args=None,
                 module_stubs=None):
    """Execute a legacy config (a file path or source text) against this
    module's vocabulary, building into the CURRENT default programs.
    Returns a ConfigRecord (outputs, settings, data sources).

    The reference flow (config_parser.parse_config -> ModelConfig proto
    -> C++ layer construction) becomes: exec the same script, Program IR
    comes out the other side.

    module_stubs: {name: module-like} injected into sys.modules during
    the exec — for configs whose sibling helpers do environment-bound
    work at import/config time (e.g. benchmark rnn/imdb.py downloads
    its dataset).
    """
    global _state
    _state = _State()
    _state.config_args = dict(config_args or {})
    _install_paddle_alias()

    if "\n" not in str(path_or_source):
        with open(path_or_source) as f:
            source = f.read()
        filename = str(path_or_source)
    else:
        source = path_or_source
        filename = "<legacy-config>"

    ns = {k: globals()[k] for k in __all__ if k in globals()}
    ns["__builtins__"] = __builtins__
    ns["xrange"] = range                       # py2-era configs
    import sys
    here = (os.path.dirname(os.path.abspath(filename))
            if filename != "<legacy-config>" else None)
    code = compile(source, filename, "exec")
    saved = {}
    for mname, mod in (module_stubs or {}).items():
        saved[mname] = sys.modules.get(mname)
        sys.modules[mname] = mod
    inserted = bool(here) and here not in sys.path
    if inserted:
        # configs import sibling helper modules (benchmark/paddle/rnn/
        # rnn.py does `import imdb`)
        sys.path.insert(0, here)
    try:
        exec(code, ns)
    finally:
        if inserted:
            sys.path.remove(here)
        for mname, prev in saved.items():
            if prev is None:
                sys.modules.pop(mname, None)
            else:
                sys.modules[mname] = prev
    return ConfigRecord(_state)


# ---------------------------------------------------------------------------
# extended vocabulary: activations, data declarations, mixed layers,
# recurrent groups and the sequence/cost layer tail
# (reference python/paddle/trainer_config_helpers/{activations,layers}.py)
# ---------------------------------------------------------------------------

BaseActivation = _Act
BReluActivation = _mk_act("BReluActivation", "brelu")
SoftReluActivation = _mk_act("SoftReluActivation", "soft_relu")
STanhActivation = _mk_act("STanhActivation", "stanh")
AbsActivation = _mk_act("AbsActivation", "abs")
SquareActivation = _mk_act("SquareActivation", "square")
ExpActivation = _mk_act("ExpActivation", "exp")
LogActivation = _mk_act("LogActivation", "log")
SqrtActivation = _mk_act("SqrtActivation", "sqrt")
ReciprocalActivation = _mk_act("ReciprocalActivation", "reciprocal")
SequenceSoftmaxActivation = _mk_act("SequenceSoftmaxActivation",
                                    "sequence_softmax")


# -- data declarations (TrainerConfig.proto DataConfig): recorded so the
# training driver can pair the config with a data path; they build no ops.

def _data_decl(kind):
    def decl(**kwargs):
        return {"type": kind, **kwargs}
    decl.__name__ = kind
    return decl


SimpleData = _data_decl("SimpleData")
ProcessData = _data_decl("ProcessData")
PyData = _data_decl("PyData")


def TrainData(decl):
    _state.settings["train_data"] = decl


def TestData(decl):
    _state.settings["test_data"] = decl


# -- mixed_layer + projections ----------------------------------------------

def _proj_materialize(x):
    return _materialize_dense(x)


class _ProjectionSpec:
    """Deferred projection: built against the owning mixed_layer's size.
    `build(None)` materialises size-preserving projections standalone
    (legacy allows bare projections as concat_layer/outputs inputs)."""

    def __init__(self, build):
        self.build = build  # size-or-None -> Variable


def full_matrix_projection(input, param_attr=None, **_compat):
    def build(size):
        v = _proj_materialize(input)
        return flayers.fc(v, size, bias_attr=False, param_attr=param_attr)
    return _ProjectionSpec(build)


def trans_full_matrix_projection(input, param_attr=None, **_compat):
    """x W^T with a (possibly shared) [size, in] weight — the legacy
    TransposedFullMatrixProjection used for tied weights
    (sample_trainer_config.conf 'sharew')."""
    def build(size):
        from .layer_helper import LayerHelper
        v = _proj_materialize(input)
        in_features = int(v.shape[-1])
        helper = LayerHelper("trans_fm_proj")
        w = helper.create_parameter(param_attr or ParamAttr(),
                                    [size, in_features], v.dtype)
        return flayers.matmul(v, w, transpose_y=True)
    return _ProjectionSpec(build)


def identity_projection(input, offset=None, **_compat):
    def build(size):
        v = _proj_materialize(input)
        if offset:
            nd = len(v.shape or ())
            return flayers.slice(v, axes=[nd - 1], starts=[offset],
                                 ends=[offset + size])
        return v
    return _ProjectionSpec(build)


def dotmul_projection(input, param_attr=None, **_compat):
    def build(size):
        from .layer_helper import LayerHelper
        v = _proj_materialize(input)
        helper = LayerHelper("dotmul_proj")
        w = helper.create_parameter(param_attr or ParamAttr(),
                                    [int(v.shape[-1])], v.dtype)
        return flayers.elementwise_mul(v, w)
    return _ProjectionSpec(build)


def slice_projection(input, slices, **_compat):
    """Concat of index ranges of the input's feature axis — the channel
    axis for image inputs (legacy SliceProjection, concat_slice_a.conf
    slices conv channels)."""
    def build(size):
        v = _proj_materialize(input)
        axis = 1 if len(v.shape or ()) == 4 else len(v.shape or ()) - 1
        parts = [flayers.slice(v, axes=[axis], starts=[s], ends=[e])
                 for s, e in slices]
        return flayers.concat(parts, axis=axis)
    return _ProjectionSpec(build)


def scaling_projection(input, param_attr=None, **_compat):
    def build(size):
        from .layer_helper import LayerHelper
        v = _proj_materialize(input)
        helper = LayerHelper("scaling_proj")
        w = helper.create_parameter(param_attr or ParamAttr(),
                                    [1], v.dtype)
        return flayers.elementwise_mul(v, w)
    return _ProjectionSpec(build)


def table_projection(input, param_attr=None, **_compat):
    def build(size):
        if not isinstance(input, _DataHandle):
            raise TypeError("table_projection input must be a data_layer")
        ids = input.as_id_sequence()
        return flayers.embedding(ids, size=[input.size, size],
                                 param_attr=param_attr)
    return _ProjectionSpec(build)


def context_projection(input, context_len, context_start=None, **_compat):
    """Concat a sliding context window along the feature dim
    (legacy ContextProjection / function/ContextProjectionOp): for each
    offset o the shifted copy pads with zeros past the sequence ends —
    which in the padded+@SEQLEN encoding is literally a shift along T."""
    def build(size):
        v = _proj_materialize(input)
        start = (-(context_len - 1) // 2 if context_start is None
                 else context_start)
        B_, T_ = v.shape[0], int(v.shape[1])
        F_ = int(v.shape[-1])
        pieces = []
        for o in range(start, start + context_len):
            if o == 0:
                pieces.append(v)
            elif o > 0:
                body = flayers.slice(v, axes=[1], starts=[o], ends=[T_])
                zer = _zeros_like_rows(v, [-1, o, F_])
                pieces.append(flayers.concat([body, zer], axis=1))
            else:
                body = flayers.slice(v, axes=[1], starts=[0], ends=[T_ + o])
                zer = _zeros_like_rows(v, [-1, -o, F_])
                pieces.append(flayers.concat([zer, body], axis=1))
        out = flayers.concat(pieces, axis=2)
        out.lod_level = v.lod_level
        out.seq_len_var = v.seq_len_var
        return out
    return _ProjectionSpec(build)


def _zeros_like_rows(ref, shape):
    """[B, ...] zeros whose batch dim tracks `ref` dynamically."""
    blk = default_main_program().current_block()
    from .framework import unique_name
    out = blk.create_var(name=unique_name("ctx_zero"), stop_gradient=True)
    blk.append_op("fill_constant_batch_size_like",
                  {"Input": [ref.name]}, {"Out": [out.name]},
                  {"shape": list(shape), "value": 0.0,
                   "dtype": ref.dtype, "input_dim_idx": 0,
                   "output_dim_idx": 0})
    default_main_program().bump()
    return out


dotmul_operator = dotmul_projection  # mixed-layer operator form


class mixed_layer:
    """`with mixed_layer(size=..., act=...) as m: m += projection(...)`
    (reference layers.py mixed_layer / MixedLayer). Sums the built
    projections, adds the optional bias, applies the activation; after
    the `with` block the object stands in for its output variable."""

    def __init__(self, size=0, act=None, bias_attr=None, name=None,
                 input=None, **_compat):
        self.size = size
        self.act = act
        self.bias_attr = bias_attr
        self.name = name
        self.projs = []
        self.var = None
        if input is not None:
            for p in (input if isinstance(input, (list, tuple))
                      else [input]):
                self.__iadd__(p)
            self._build()

    def __iadd__(self, proj):
        if not isinstance(proj, _ProjectionSpec):
            # legacy also admits plain layers (e.g. a standalone
            # conv_projection result) as identity contributions
            val = proj
            proj = _ProjectionSpec(lambda size, _v=val:
                                   _materialize_dense(_v))
        self.projs.append(proj)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self._build()
        return False

    def _build(self):
        if not self.projs:
            raise ValueError("mixed_layer has no projections")
        outs = [p.build(self.size or None) for p in self.projs]
        out = outs[0] if len(outs) == 1 else flayers.sums(outs)
        if len(outs) > 1:
            out.lod_level = outs[0].lod_level
            out.seq_len_var = outs[0].seq_len_var
        from .layer_helper import LayerHelper
        helper = LayerHelper("mixed", name=self.name)
        if self.bias_attr is True or isinstance(self.bias_attr, ParamAttr):
            battr = (self.bias_attr if isinstance(self.bias_attr, ParamAttr)
                     else ParamAttr())
            if len(out.shape or ()) == 4:
                # image output: shared per-channel bias (legacy
                # shared_biases convention for conv-fed mixed layers)
                b = helper.create_parameter(
                    battr, [int(out.shape[1])], out.dtype, is_bias=True)
                out = flayers.elementwise_add(out, b, axis=1)
            else:
                b = helper.create_parameter(
                    battr, [self.size or int(out.shape[-1])], out.dtype,
                    is_bias=True)
                out = flayers.elementwise_add(out, b)
        op = _act_op(self.act)
        if op:
            out = helper.append_activation(out, op)
        self.var = out
        # behave like the variable for downstream wrappers
        self.name_ = out.name


def _unwrap(x):
    if isinstance(x, mixed_layer):
        if x.var is None:
            raise ValueError("mixed_layer used before its `with` block "
                             "closed")
        return x.var
    if isinstance(x, _ProjectionSpec):
        return x.build(None)   # bare projection as a layer input
    return x


CudnnMaxPooling = MaxPooling   # device hints in legacy configs;
CudnnAvgPooling = AvgPooling   # pooling math is identical here


# route every wrapper through the mixed_layer unwrap as well
_orig_materialize_dense = _materialize_dense


def _materialize_dense(x):  # noqa: F811
    return _orig_materialize_dense(_unwrap(x))


# -- recurrent machinery ----------------------------------------------------

from .layers.rnn_group import (  # noqa: E402
    recurrent_group as _fl_recurrent_group, memory as _fl_memory,
    StaticInput, SubsequenceInput)


def memory(name, size, boot_layer=None, **_compat):
    return _fl_memory(name, size,
                      boot_layer=_materialize_dense(boot_layer)
                      if boot_layer is not None else None)


def recurrent_group(step, input, reverse=False, name=None, **_compat):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    resolved = []
    for i in inputs:
        if isinstance(i, StaticInput):
            resolved.append(StaticInput(_materialize_dense(i.var)))
        elif isinstance(i, SubsequenceInput):
            v = (i.var.as_id_subsequence()
                 if isinstance(i.var, _DataHandle) else _unwrap(i.var))
            resolved.append(SubsequenceInput(v))
        elif isinstance(i, _DataHandle):
            resolved.append(i.as_id_sequence())
        else:
            resolved.append(_unwrap(i))
    return _fl_recurrent_group(step=step, input=resolved,
                               reverse=reverse, name=name)


def lstmemory(input, size=None, reverse=False, act=None, gate_act=None,
              state_act=None, name=None, **_compat):
    """Fused LSTM over a pre-projected [B, T, 4*size] sequence
    (legacy lstmemory; the '(mixed 4x + lstm) == lstmemory' contract in
    sequence_lstm.conf). Lowered to the `lstm` op."""
    v = _materialize_dense(input)
    size = size or int(v.shape[-1]) // 4
    hidden, _cell = flayers.dynamic_lstm(
        v, size * 4, is_reverse=reverse, name=name,
        gate_activation=_act_op_or(gate_act, "sigmoid"),
        cell_activation=_act_op_or(state_act, "tanh"),
        candidate_activation=_act_op_or(act, "tanh"))
    return hidden


def grumemory(input, size=None, reverse=False, act=None, gate_act=None,
              name=None, **_compat):
    v = _materialize_dense(input)
    size = size or int(v.shape[-1]) // 3
    return flayers.dynamic_gru(
        v, size, is_reverse=reverse, name=name,
        gate_activation=_act_op_or(gate_act, "sigmoid"),
        candidate_activation=_act_op_or(act, "tanh"))


def lstmemory_group(input, size=None, reverse=False, act=None,
                    gate_act=None, state_act=None, name=None, **_compat):
    """LSTM built from an explicit recurrent_group step (legacy
    lstmemory_group, networks.py): hidden/cell memories + a per-step
    lstm_unit. Gate order i,f,o,g (lstm_unit contract)."""
    from .framework import unique_name
    v = _materialize_dense(input)
    size = size or int(v.shape[-1]) // 4
    gname = name or unique_name("lstm_group")

    def step(x4):
        h = memory(name=gname + "@h", size=size)
        c = memory(name=gname + "@c", size=size)
        rec = flayers.fc(h, size * 4, bias_attr=False)
        gates = flayers.elementwise_add(x4, rec)
        blk = default_main_program().current_block()
        cvar = blk.create_var(name=unique_name(gname + "@c.step"))
        hvar = blk.create_var(name=unique_name(gname + "@h.step"))
        blk.append_op("lstm_unit", {"X": [gates.name],
                                    "C_prev": [c.name]},
                      {"C": [cvar.name], "H": [hvar.name]},
                      {"forget_bias": 0.0})
        default_main_program().bump()
        return hvar

    return recurrent_group(step=step, input=v, reverse=reverse,
                           name=gname)


def gru_group(input, size=None, reverse=False, act=None, gate_act=None,
              name=None, **_compat):
    """GRU from an explicit step (legacy gru_group): one gru_unit per
    step — the unit op owns the recurrent weight."""
    from .framework import unique_name
    from .layer_helper import LayerHelper
    v = _materialize_dense(input)
    size = size or int(v.shape[-1]) // 3
    gname = name or unique_name("gru_group")
    helper = LayerHelper(gname)
    w = helper.create_parameter(ParamAttr(), [size, size * 3], "float32")

    def step(x3):
        h = memory(name=gname + "@h", size=size)
        blk = default_main_program().current_block()
        gate = blk.create_var(name=unique_name(gname + "@gate"))
        rhp = blk.create_var(name=unique_name(gname + "@rhp"))
        hvar = blk.create_var(name=unique_name(gname + "@h.step"))
        blk.append_op("gru_unit",
                      {"Input": [x3.name], "HiddenPrev": [h.name],
                       "Weight": [w.name]},
                      {"Gate": [gate.name], "ResetHiddenPrev": [rhp.name],
                       "Hidden": [hvar.name]}, {})
        default_main_program().bump()
        return hvar

    return recurrent_group(step=step, input=v, reverse=reverse,
                           name=gname)


def simple_gru(input, size, **kw):
    from .v2 import networks as v2n
    return v2n.simple_gru(_materialize_dense(input), size, **kw) \
        if hasattr(v2n, "simple_gru") else grumemory(
            fc_layer(input, size * 3, bias_attr=True), size)


def bidirectional_lstm(input, size, return_seq=False, **_compat):
    fwd_in = fc_layer(input, size * 4, bias_attr=True)
    bwd_in = fc_layer(input, size * 4, bias_attr=True)
    fwd = lstmemory(fwd_in, size=size)
    bwd = lstmemory(bwd_in, size=size, reverse=True)
    if return_seq:
        out = flayers.concat([fwd, bwd], axis=2)
        out.lod_level = fwd.lod_level
        out.seq_len_var = fwd.seq_len_var
        return out
    # Legacy networks.py concatenates last_seq(fwd) with FIRST_seq(bwd):
    # the reverse LSTM's informative final state sits at t=0.
    return flayers.concat([flayers.sequence_last_step(fwd),
                           flayers.sequence_first_step(bwd)], axis=1)


# -- sequence / math / specialty layer tail ---------------------------------

def pooling_layer(input, pooling_type=None, name=None, **_compat):
    v = _materialize_dense(input)
    kind = {"max": "max", "avg": "average", "sum": "sum"}[
        getattr(pooling_type, "kind", "max")]
    return flayers.sequence_pool(v, pool_type=kind, name=name)


def cos_sim(a, b, scale=1.0, name=None, **_compat):
    out = flayers.cos_sim(_materialize_dense(a), _materialize_dense(b),
                          name=name)
    return out if scale == 1.0 else flayers.scale(out, scale=scale)


def tensor_layer(a, b, size, act=None, param_attr=None, bias_attr=None,
                 name=None, **_compat):
    """Bilinear a W_k b^T (legacy TensorLayer -> bilinear_tensor_product
    op)."""
    from .layer_helper import LayerHelper
    from .framework import unique_name
    va, vb = _materialize_dense(a), _materialize_dense(b)
    helper = LayerHelper("tensor", name=name)
    w = helper.create_parameter(param_attr or ParamAttr(),
                                [size, int(va.shape[-1]),
                                 int(vb.shape[-1])], va.dtype)
    out = helper.create_tmp_variable(va.dtype)
    ins = {"X": [va.name], "Y": [vb.name], "Weight": [w.name]}
    if bias_attr is True or isinstance(bias_attr, ParamAttr):
        battr = bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr()
        bb = helper.create_parameter(battr, [1, size], va.dtype,
                                     is_bias=True)
        ins["Bias"] = [bb.name]
    helper.append_op("bilinear_tensor_product", ins, {"Out": [out.name]}, {})
    return helper.append_activation(out, _act_op(act))


def conv_shift_layer(a, b, name=None, **_compat):
    from .layer_helper import LayerHelper
    helper = LayerHelper("conv_shift", name=name)
    va, vb = _materialize_dense(a), _materialize_dense(b)
    out = helper.create_tmp_variable(va.dtype)
    helper.append_op("conv_shift", {"X": [va.name], "Y": [vb.name]},
                     {"Out": [out.name]}, {})
    return out


def maxout_layer(input, groups, num_channels=None, name=None, **_compat):
    x = _as_image(input, num_channels) if num_channels else \
        _materialize_dense(input)
    return flayers.maxout(x, groups, name=name)


def block_expand_layer(input, block_x=1, block_y=1, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, num_channels=None,
                       name=None, **_compat):
    """Image -> sequence of blocks (legacy BlockExpandLayer ==
    im2sequence op)."""
    x = _as_image(input, num_channels)
    return flayers.im2sequence(x, filter_size=[block_y, block_x],
                               stride=[stride_y, stride_x],
                               padding=[padding_y, padding_x], name=name)


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None,
                          **_compat):
    return flayers.scale(_materialize_dense(input), scale=slope,
                         bias=intercept, name=name)


def power_layer(input, weight, name=None, **_compat):
    """y = x^w with w a [B,1] per-row exponent (legacy PowerLayer)."""
    return flayers.elementwise_pow(
        _materialize_dense(input), _materialize_dense(weight), axis=0)


def scaling_layer(input, weight, name=None, **_compat):
    """Row-wise rescale y_i = w_i * x_i (legacy ScalingLayer); weight is
    [B, 1]."""
    return flayers.elementwise_mul(
        _materialize_dense(input), _materialize_dense(weight), axis=0)


def interpolation_layer(input, weight, name=None, **_compat):
    """y = w*x1 + (1-w)*x2, w in [0,1] per row (legacy
    InterpolationLayer)."""
    x1 = _materialize_dense(input[0])
    x2 = _materialize_dense(input[1])
    w = _materialize_dense(weight)
    a = flayers.elementwise_mul(x1, w, axis=0)
    negw = flayers.scale(w, scale=-1.0, bias=1.0)
    b = flayers.elementwise_mul(x2, negw, axis=0)
    return flayers.elementwise_add(a, b)


def trans_layer(input, name=None, **_compat):
    return flayers.transpose(_materialize_dense(input), [1, 0], name=name)


def repeat_layer(input, num_repeats, name=None, **_compat):
    v = _materialize_dense(input)
    times = [1] * (len(v.shape or ()) - 1) + [int(num_repeats)]
    return flayers.expand(v, expand_times=times, name=name)


def seq_reshape_layer(input, reshape_size, name=None, **_compat):
    return flayers.sequence_reshape(_materialize_dense(input),
                                    reshape_size, name=name)


def expand_layer(input, expand_as, name=None, expand_level=None,
                 **_compat):
    v = _materialize_dense(input)
    ref = _materialize_dense(expand_as)
    if ref.lod_level >= 2 and v.lod_level == 1:
        # FROM_SEQUENCE into a nested ref: broadcast each per-
        # subsequence vector across its subsequence's timesteps
        # ([B, S, H] -> [B, S, T, H] with the ref's lengths). T is
        # dynamic metadata, so the broadcast happens in-op against the
        # runtime ref shape.
        H = int(v.shape[-1])
        out = _append1("sequence_expand_nested",
                       {"X": [v.name], "Ref": [ref.name]},
                       name=name, dtype=v.dtype)
        out.shape = (-1, -1, -1, H)
        out.lod_level = 2
        out.seq_len_var = ref.seq_len_var
        out.sub_seq_len_var = ref.sub_seq_len_var
        return out
    return flayers.sequence_expand(v, ref, name=name)


def seq_concat_layer(a, b, name=None, **_compat):
    return flayers.sequence_concat(
        [_materialize_dense(a), _materialize_dense(b)], name=name)


# -- cost tail ---------------------------------------------------------------

def sum_cost(input, name=None, **_compat):
    return flayers.reduce_sum(_materialize_dense(input), name=name)


def huber_regression_cost(input, label, delta=1.0, name=None, **_compat):
    from .layer_helper import LayerHelper
    helper = LayerHelper("huber_regression", name=name)
    v, l = _materialize_dense(input), _materialize_dense(label)
    out = helper.create_tmp_variable(v.dtype)
    resid = helper.create_tmp_variable(v.dtype)
    helper.append_op("huber_loss", {"X": [v.name], "Y": [l.name]},
                     {"Out": [out.name], "Residual": [resid.name]},
                     {"delta": float(delta)})
    return flayers.mean(out)


def rank_cost(left, right, label, name=None, **_compat):
    from .layer_helper import LayerHelper
    helper = LayerHelper("rank_cost", name=name)
    l_ = _materialize_dense(left)
    r_ = _materialize_dense(right)
    lab = _materialize_dense(label)
    out = helper.create_tmp_variable(l_.dtype)
    helper.append_op("rank_loss", {"Left": [l_.name], "Right": [r_.name],
                                   "Label": [lab.name]},
                     {"Out": [out.name]}, {})
    return flayers.mean(out)


def multi_binary_label_cross_entropy(input, label, name=None, **_compat):
    """Legacy multi_binary_label_cross_entropy receives sigmoid-ACTIVATED
    probabilities (classification_cost convention), so BCE is computed
    directly on probabilities via the log_loss op — applying
    sigmoid_cross_entropy_with_logits here would double-sigmoid."""
    from .layer_helper import LayerHelper
    helper = LayerHelper("multi_binary_label_ce", name=name)
    p = _materialize_dense(input)
    y = _materialize_dense(label)
    out = helper.create_tmp_variable(p.dtype)
    helper.append_op("log_loss", {"Predicted": [p.name], "Labels": [y.name]},
                     {"Loss": [out.name]}, {"epsilon": 1e-7})
    return flayers.mean(out)


def nce_layer(input, label, num_classes, num_neg_samples=10,
              param_attr=None, bias_attr=None, name=None, **_compat):
    return flayers.nce(_materialize_dense(input), _label_of(label),
                       num_total_classes=num_classes,
                       num_neg_samples=num_neg_samples,
                       param_attr=param_attr, bias_attr=bias_attr,
                       name=name)


def hsigmoid(input, label, num_classes=None, param_attr=None,
             bias_attr=None, name=None, **_compat):
    ins = input if isinstance(input, (list, tuple)) else [input]
    vs = [_materialize_dense(i) for i in ins]
    if isinstance(param_attr, (list, tuple)):
        raise NotImplementedError(
            "hsigmoid: per-input param_attr lists are not supported — "
            "the inputs concatenate into ONE blockwise weight; pass a "
            "single ParamAttr (or name slices yourself)")
    # legacy hsigmoid sums per-input projections == one projection over
    # the concatenation (blockwise weights)
    v = vs[0] if len(vs) == 1 else flayers.concat(vs, axis=1)
    lab = _label_of(label)
    if num_classes is None:
        num_classes = int(getattr(label, "size", 0))
    if num_classes < 2:
        raise ValueError(
            "hsigmoid needs num_classes >= 2 (pass it explicitly; the "
            "label data_layer's size does not define a usable class "
            "count here)")
    # legacy cost layers reduce over the batch (the trainer sums costs);
    # per-example costs stay available via layers.hsigmoid directly
    return flayers.mean(flayers.hsigmoid(
        v, lab, num_classes, param_attr=param_attr, bias_attr=bias_attr,
        name=name))


def crf_layer(input, label, size=None, param_attr=None, name=None,
              **_compat):
    return flayers.linear_chain_crf(_materialize_dense(input),
                                    _label_of(label),
                                    param_attr=param_attr, name=name)


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       name=None, **_compat):
    return flayers.crf_decoding(_materialize_dense(input),
                                param_attr or ParamAttr(name="crfw"),
                                label=_label_of(label) if label else None,
                                name=name)


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False,
              name=None, **_compat):
    v = _materialize_dense(input)
    blank = (int(v.shape[-1]) - 1) if blank is None else blank
    lab = (label.as_id_sequence() if isinstance(label, _DataHandle)
           else label)
    return flayers.warpctc(v, lab, blank=blank,
                           norm_by_times=norm_by_times, name=name)


def warp_ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
                   name=None, **_compat):
    """warp-ctc convention: blank defaults to index 0 (reference
    warp_ctc_layer), unlike ctc_layer whose default blank is size-1."""
    return ctc_layer(input, label, size=size, blank=blank,
                     norm_by_times=norm_by_times, name=name, **_compat)


__all__ += [
    "BaseActivation", "BReluActivation", "SoftReluActivation",
    "STanhActivation", "AbsActivation", "SquareActivation",
    "ExpActivation", "LogActivation", "SqrtActivation",
    "ReciprocalActivation", "SequenceSoftmaxActivation",
    "TrainData", "TestData", "SimpleData", "ProcessData", "PyData",
    "mixed_layer", "full_matrix_projection",
    "trans_full_matrix_projection", "identity_projection",
    "dotmul_projection", "scaling_projection", "table_projection",
    "context_projection", "dotmul_operator",
    "recurrent_group", "memory", "StaticInput", "SubsequenceInput",
    "lstmemory", "grumemory", "lstmemory_group", "gru_group",
    "simple_gru", "bidirectional_lstm",
    "pooling_layer", "cos_sim", "tensor_layer", "conv_shift_layer",
    "maxout_layer", "block_expand_layer", "slope_intercept_layer",
    "power_layer", "scaling_layer", "interpolation_layer", "trans_layer",
    "repeat_layer", "seq_reshape_layer", "expand_layer",
    "seq_concat_layer",
    "slice_projection", "CudnnMaxPooling", "CudnnAvgPooling",
    "sum_cost", "huber_regression_cost", "rank_cost",
    "multi_binary_label_cross_entropy", "nce_layer", "hsigmoid",
    "crf_layer", "crf_decoding_layer", "ctc_layer", "warp_ctc_layer",
]


# ---------------------------------------------------------------------------
# vocabulary tail: the rest of the reference layer surface
# (reference python/paddle/trainer_config_helpers/layers.py __all__;
# each wrapper lowers to the op library rather than reimplementing math)
# ---------------------------------------------------------------------------

class AggregateLevel:
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = "non-seq"     # legacy alias
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    FROM_NO_SEQUENCE = "non-seq"
    FROM_SEQUENCE = "seq"
    FROM_TIMESTEP = "non-seq"     # legacy alias


class LayerType:
    """Name constants kept for configs that reference them; the Program
    IR tracks ops, not gserver layer types."""
    DATA = "data"
    FC = "fc"
    COST = "cost"


LayerOutput = object            # configs isinstance-check against it


def layer_support(*args, **kw):
    """Legacy decorator advertising layer attr support; semantically a
    no-op here (attrs are honored per-wrapper)."""
    def deco(fn):
        return fn
    return deco if not (len(args) == 1 and callable(args[0])) else args[0]


def get_output_layer(input, arg_name=None, name=None, **_compat):
    """Secondary-output selector: step layers stash their extra output
    (lstm_step_layer's cell) as `.step_state`; everything else is
    single-output and the selector is the identity."""
    v = _materialize_dense(input)
    if arg_name == "state" and getattr(v, "step_state", None) is not None:
        return v.step_state
    return v


def _append1(op, ins, attrs=None, name=None, dtype=None, n_out=1,
             out_slots=("Out",)):
    """One-op wrapper plumbing: materialize inputs, create out vars,
    append, return."""
    from .layer_helper import LayerHelper
    helper = LayerHelper(op, name=name)
    outs = [helper.create_tmp_variable(dtype or "float32")
            for _ in range(n_out)]
    helper.append_op(op, ins, {slot: [o.name] for slot, o
                               in zip(out_slots, outs)}, attrs or {})
    return outs[0] if n_out == 1 else outs


# -- costs -------------------------------------------------------------------

square_error_cost = regression_cost   # same cost, reference's r2 spelling


def smooth_l1_cost(input, label, name=None, **_compat):
    v, l = _materialize_dense(input), _materialize_dense(label)
    out = _append1("smooth_l1_loss", {"X": [v.name], "Y": [l.name]},
                   {"sigma": 1.0}, name=name, n_out=2,
                   out_slots=("Out", "Diff"))[0]
    return flayers.mean(out)


def huber_classification_cost(input, label, name=None, **_compat):
    v = _materialize_dense(input)
    lab = _materialize_dense(label)
    out = _append1("modified_huber_loss",
                   {"X": [v.name], "Y": [lab.name]}, name=name, n_out=2,
                   out_slots=("Out", "IntermediateVal"))[0]
    return flayers.mean(out)


def cross_entropy_with_selfnorm(input, label, coeff=1.0,
                                softmax_selfnorm_alpha=0.1, name=None,
                                **_compat):
    """CE plus alpha * log(Z)^2 keeping the (possibly unnormalised)
    class-score sum near 1 (reference layers.py)."""
    v = _materialize_dense(input)
    ce = flayers.cross_entropy(v, _label_of(label))
    z = flayers.reduce_sum(v, dim=[1], keep_dim=True)
    logz = flayers.log(z)
    # reference CostLayer.cpp:113: CE + log(Z) + alpha*log(Z)^2 — the
    # +log(Z) term is what corrects CE for unnormalised scores
    reg = flayers.elementwise_add(
        logz, flayers.scale(flayers.square(logz),
                            scale=float(softmax_selfnorm_alpha)))
    return flayers.scale(flayers.mean(ce + reg), scale=float(coeff))


# -- row-wise math -----------------------------------------------------------

def l2_distance_layer(x, y, name=None, **_compat):
    a, b = _materialize_dense(x), _materialize_dense(y)
    sq = _append1("squared_l2_distance",
                  {"X": [a.name], "Y": [b.name]}, name=name, n_out=2,
                  out_slots=("Out", "sub_result"))[0]
    return flayers.sqrt(sq)


def dot_prod_layer(input1, input2, name=None, **_compat):
    a, b = _materialize_dense(input1), _materialize_dense(input2)
    return flayers.reduce_sum(flayers.elementwise_mul(a, b), dim=[1],
                              keep_dim=True)


def out_prod_layer(input1, input2, name=None, **_compat):
    """Row-wise outer product flattened to [B, M*N] (OuterProdLayer)."""
    a, b = _materialize_dense(input1), _materialize_dense(input2)
    M, N = int(a.shape[-1]), int(b.shape[-1])
    am = flayers.reshape(a, shape=[-1, M, 1])
    bm = flayers.reshape(b, shape=[-1, 1, N])
    return flayers.reshape(flayers.matmul(am, bm), shape=[-1, M * N])


def linear_comb_layer(weights, vectors, size, name=None, **_compat):
    """out[b] = sum_m w[b,m] * V[b,m,:] (LinearCombLayer): weights
    [B, M], vectors [B, M*size]."""
    w, v = _materialize_dense(weights), _materialize_dense(vectors)
    M = int(w.shape[-1])
    vm = flayers.reshape(v, shape=[-1, M, int(size)])
    wm = flayers.reshape(w, shape=[-1, 1, M])
    return flayers.reshape(flayers.matmul(wm, vm), shape=[-1, int(size)])


convex_comb_layer = linear_comb_layer     # legacy alias


def sum_to_one_norm_layer(input, name=None, **_compat):
    v = _materialize_dense(input)
    s = flayers.reduce_sum(v, dim=[1], keep_dim=True)
    return flayers.elementwise_div(v, s)


def row_l2_norm_layer(input, name=None, **_compat):
    return flayers.l2_normalize(_materialize_dense(input), axis=1)


def clip_layer(input, min, max, name=None, **_compat):  # noqa: A002
    v = _materialize_dense(input)
    return _append1("clip", {"X": [v.name]},
                    {"min": float(min), "max": float(max)}, name=name)


def resize_layer(input, size, name=None, **_compat):
    return flayers.reshape(_materialize_dense(input),
                           shape=[-1, int(size)])


def scale_shift_layer(input, name=None, param_attr=None, bias_attr=None,
                      **_compat):
    """y = w*x + b with SCALAR learned w (and b) — ScaleShiftLayer."""
    from .layer_helper import LayerHelper
    v = _materialize_dense(input)
    helper = LayerHelper("scale_shift", name=name)
    w = helper.create_parameter(param_attr or ParamAttr(), [1], "float32")
    out = flayers.elementwise_mul(v, w)
    if bias_attr is not False:
        b = helper.create_parameter(
            bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr(),
            [1], "float32", is_bias=True)
        out = flayers.elementwise_add(out, b)
    return out


def factorization_machine(input, factor_size, name=None, param_attr=None,
                          **_compat):
    """Second-order FM interaction term (factorization_machine_layer):
    0.5 * sum_f [ (x V)_f^2 - (x^2)(V^2)_f ]."""
    from .layer_helper import LayerHelper
    v = _materialize_dense(input)
    helper = LayerHelper("fm", name=name)
    vmat = helper.create_parameter(param_attr or ParamAttr(),
                                   [int(v.shape[-1]), int(factor_size)],
                                   "float32")
    xv = flayers.matmul(v, vmat)                      # [B, F]
    x2v2 = flayers.matmul(flayers.square(v), flayers.square(vmat))
    return flayers.scale(
        flayers.reduce_sum(flayers.elementwise_sub(flayers.square(xv),
                                                   x2v2),
                           dim=[1], keep_dim=True), scale=0.5)


def gated_unit_layer(input, size, act=None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=True,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=True, name=None, **_compat):
    """GLU (gated_unit_layer): proj(x) * sigmoid(gate(x))."""
    v = _materialize_dense(input)
    proj = flayers.fc(v, int(size), act=_act_op(act),
                      param_attr=inproj_param_attr,
                      bias_attr=inproj_bias_attr)
    gate = flayers.fc(v, int(size), act="sigmoid",
                      param_attr=gate_param_attr,
                      bias_attr=gate_bias_attr)
    return flayers.elementwise_mul(proj, gate)


def selective_fc_layer(input, size, select=None, act=None,
                       param_attr=None, bias_attr=None, name=None,
                       **_compat):
    """SelectiveFcLayer: with select=None (the common config case) the
    output equals a dense fc; the sparse-selection fast path is a CPU
    serving optimisation with no analog here, so selection is applied as
    a mask when given."""
    v = _materialize_dense(input)
    out = flayers.fc(v, int(size), act=_act_op(act),
                     param_attr=param_attr, bias_attr=bias_attr,
                     name=name)
    if select is not None:
        out = flayers.elementwise_mul(out, _materialize_dense(select))
    return out


# -- shape / image ops -------------------------------------------------------

def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None,
              **_compat):
    v = _materialize_dense(input)
    if len(v.shape) != 4:
        raise ValueError(
            f"pad_layer expects NCHW input, got rank {len(v.shape)} "
            "(the legacy layer pads image channels/rows/cols)")
    pc = list(pad_c or [0, 0])
    ph = list(pad_h or [0, 0])
    pw = list(pad_w or [0, 0])
    paddings = [0, 0] + pc + ph + pw
    return _append1("pad", {"X": [v.name]},
                    {"paddings": paddings, "pad_value": 0.0}, name=name)


def crop_layer(input, offset, shape=None, axis=2, name=None, **_compat):
    """Crop to an explicit shape, or — when `input` is a pair and shape
    is None — to the shape of the second (reference) input from `axis`
    on (reference layers.py:6915 CropLayer's two-input form)."""
    ref = None
    if isinstance(input, (list, tuple)):
        if len(input) > 1:
            ref = _materialize_dense(input[1])
        input = input[0]
    v = _materialize_dense(input)
    if shape is None:
        if ref is None:
            raise ValueError("crop_layer: pass an explicit shape or a "
                             "second (reference) input to crop to")
        shape = [int(s) for s in ref.shape[axis:]]
        if any(s < 0 for s in shape):
            raise ValueError("crop_layer: the reference input's cropped "
                             "dims must be static")
    full_off = [0] * axis + list(offset)
    return _append1("crop", {"X": [v.name]},
                    {"offsets": full_off, "shape": list(shape)},
                    name=name)


def multiplex_layer(input, name=None, **_compat):
    """First input selects among the rest per row (multiplex_op)."""
    vs = [_materialize_dense(i) for i in input]
    return flayers.multiplex(vs[1:], vs[0], name=name)


def prelu_layer(input, partial_sum=1, param_attr=None, name=None,
                **_compat):
    """PReLU with per-channel alpha (channel_shared via partial_sum=全
    is the 'all' mode)."""
    from .layer_helper import LayerHelper
    import numpy as _np
    v = _materialize_dense(input)
    helper = LayerHelper("prelu", name=name)
    # legacy semantics: one alpha per `partial_sum` input elements —
    # partial_sum=1 is element-wise, H*W is channel-shared, C*H*W is
    # one shared scalar
    ps = int(partial_sum or 1)
    feat = int(_np.prod([int(d) for d in v.shape[1:]]))
    if ps == feat:
        mode, n_alpha = "all", 1
    elif ps == 1:
        mode, n_alpha = "element", feat
    elif (len(v.shape) == 4
          and ps == int(v.shape[2]) * int(v.shape[3])):
        mode, n_alpha = "channel", int(v.shape[1])
    else:
        raise ValueError(
            f"prelu_layer: partial_sum={ps} does not map to element/"
            f"channel/all for input shape {tuple(v.shape)}")
    alpha = helper.create_parameter(param_attr or ParamAttr(),
                                    [n_alpha], "float32")
    out = helper.create_tmp_variable(v.dtype)
    helper.append_op("prelu", {"X": [v.name], "Alpha": [alpha.name]},
                     {"Out": [out.name]}, {"mode": mode})
    return out


def row_conv_layer(input, context_len, act=None, param_attr=None,
                   name=None, **_compat):
    v = _materialize_dense(input)
    out = flayers.row_conv(v, future_context_size=int(context_len) - 1,
                           param_attr=param_attr, name=name)
    op = _act_op(act)
    return getattr(flayers, op)(out) if op else out


def bilinear_interp_layer(input, out_size_x, out_size_y, name=None,
                          **_compat):
    v = _materialize_dense(input)
    return _append1("bilinear_interp", {"X": [v.name]},
                    {"out_h": int(out_size_y), "out_w": int(out_size_x)},
                    name=name, dtype=v.dtype)


def rotate_layer(input, height=None, width=None, name=None, **_compat):
    v = _materialize_dense(input)
    if isinstance(input, _DataHandle) or len(v.shape) == 2:
        h = height or getattr(input, "height", None)
        w = width or getattr(input, "width", None)
        c = int(v.shape[-1]) // (int(h) * int(w))
        v = flayers.reshape(v, shape=[-1, c, int(h), int(w)])
    return _append1("rotate", {"X": [v.name]}, name=name, dtype=v.dtype)


def switch_order_layer(input, reshape_axis=None, name=None, **_compat):
    """NCHW <-> NHWC flip (SwitchOrderLayer)."""
    v = _materialize_dense(input)
    return flayers.transpose(v, perm=[0, 2, 3, 1], name=name)


def maxid_layer(input, name=None, **_compat):
    return flayers.argmax(_materialize_dense(input), axis=1)


def sampling_id_layer(input, name=None, **_compat):
    v = _materialize_dense(input)
    return _append1("sampling_id", {"X": [v.name]}, name=name,
                    dtype="int64")


def eos_layer(input, eos_id, name=None, **_compat):
    """1 where the id equals eos_id (EosIdCheckLayer)."""
    v = _materialize_dense(input)
    eos = flayers.fill_constant([1], "int64", int(eos_id))
    eq = _append1("equal", {"X": [v.name], "Y": [eos.name]}, name=name,
                  dtype="bool")
    from .layers import tensor as _T
    return _T.cast(eq, "int64")


def print_layer(input, format=None, name=None, **_compat):  # noqa: A002
    v = _materialize_dense(input)
    flayers.Print(v, message=format or (name or "print_layer"))
    return v


printer_layer = print_layer


# -- detection / region ------------------------------------------------------

def priorbox_layer(input, image, aspect_ratio, variance, min_size,
                   max_size=None, name=None, **_compat):
    """SSD anchors for one feature map. Returns the boxes flattened to
    [P, 4]; the matching variances ride along as `.prior_var` so the
    legacy multibox_loss / detection_output shims can recover them
    (the reference priorbox layer interleaves box+variance in one
    output, layers.py:1126)."""
    v = _materialize_dense(input)
    img = _materialize_dense(image)
    box, var = flayers.prior_box(
        v, img, min_sizes=list(min_size),
        max_sizes=list(max_size or []),
        aspect_ratios=list(aspect_ratio), variance=list(variance))
    flat = flayers.reshape(box, shape=[-1, 4])      # [H*W*P, 4]
    flat.prior_var = flayers.reshape(var, shape=[-1, 4])
    return flat


def _legacy_ssd_preds(input_loc, input_conf, num_classes):
    """Translate the legacy per-branch conv layouts ([B, priors*4, H, W]
    loc and [B, priors*C, H, W] conf feature maps, reference
    MultiBoxLossLayer.cpp) into the fluid concatenated [B, P, 4] /
    [B, P, C] prediction layout the ssd_loss / detection_output math
    takes."""
    locs = input_loc if isinstance(input_loc, (list, tuple)) \
        else [input_loc]
    confs = input_conf if isinstance(input_conf, (list, tuple)) \
        else [input_conf]
    if len(locs) != len(confs):
        raise ValueError("multibox: input_loc and input_conf must pair "
                         "up one feature map each")
    loc_list, conf_list = [], []
    for lv, cv in zip(locs, confs):
        l = _materialize_dense(lv)                  # [B, P4, H, W]
        _, C, H, W = (int(s) for s in l.shape)
        l = flayers.transpose(l, [0, 2, 3, 1])
        loc_list.append(flayers.reshape(
            l, shape=[-1, H * W * (C // 4), 4]))
        c = _materialize_dense(cv)
        _, Cc, Hc, Wc = (int(s) for s in c.shape)
        c = flayers.transpose(c, [0, 2, 3, 1])
        conf_list.append(flayers.reshape(
            c, shape=[-1, Hc * Wc * (Cc // num_classes), num_classes]))
    loc = (loc_list[0] if len(loc_list) == 1
           else flayers.concat(loc_list, axis=1))
    conf = (conf_list[0] if len(conf_list) == 1
            else flayers.concat(conf_list, axis=1))
    return loc, conf


def _legacy_priorbox(priorbox):
    boxes = priorbox if isinstance(priorbox, (list, tuple)) \
        else [priorbox]
    boxes = [_materialize_dense(b) for b in boxes]
    if any(getattr(b, "prior_var", None) is None for b in boxes):
        raise ValueError("multibox: priorbox must come from "
                         "priorbox_layer (carries its variances)")
    if len(boxes) == 1:
        return boxes[0], boxes[0].prior_var
    pb = flayers.concat(boxes, axis=0)
    pv = flayers.concat([b.prior_var for b in boxes], axis=0)
    return pb, pv


def multibox_loss_layer(input_loc, input_conf, priorbox, label,
                        num_classes, overlap_threshold=0.5,
                        neg_pos_ratio=3.0, neg_overlap=0.5,
                        background_id=0, name=None, **_compat):
    """Legacy-layout SSD training loss (reference layers.py:1174 /
    MultiBoxLossLayer.cpp): per-branch conv predictions + priorbox
    layer + gt label sequence rows of (label, xmin, ymin, xmax, ymax,
    ...). Translates the layouts and lowers onto layers.ssd_loss (the
    fluid-form math: bipartite match, encode, smooth-L1 + mined
    softmax)."""
    loc, conf = _legacy_ssd_preds(input_loc, input_conf, num_classes)
    pb, pv = _legacy_priorbox(priorbox)
    lab = _materialize_dense(label)                 # [B, G, >=5]
    gt_label = flayers.cast(
        flayers.squeeze(flayers.slice(lab, axes=[2], starts=[0],
                                      ends=[1]), axes=[2]), "int64")
    gt_box = flayers.slice(lab, axes=[2], starts=[1], ends=[5])
    cost = flayers.ssd_loss(loc, conf, gt_box, gt_label, pb,
                            prior_box_var=pv,
                            background_label=int(background_id),
                            overlap_threshold=float(overlap_threshold),
                            neg_pos_ratio=float(neg_pos_ratio))
    return flayers.mean(cost)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400,
                           keep_top_k=200, confidence_threshold=0.01,
                           background_id=0, name=None, **_compat):
    """Legacy-layout SSD inference head (reference layers.py:1249 /
    DetectionOutputLayer.cpp): softmax the per-branch conf maps, decode
    against the priors, per-class NMS. Output [B, keep_top_k, 6] rows
    of (label, score, x1, y1, x2, y2) — the reference flattens batch
    into an image-id column instead; same boxes."""
    loc, conf = _legacy_ssd_preds(input_loc, input_conf, num_classes)
    pb, pv = _legacy_priorbox(priorbox)
    scores = flayers.softmax(conf)
    out, _count = flayers.detection_output(
        loc, scores, pb, prior_box_var=pv,
        background_label=int(background_id),
        nms_threshold=float(nms_threshold), nms_top_k=int(nms_top_k),
        keep_top_k=int(keep_top_k),
        score_threshold=float(confidence_threshold), name=name)
    return out


def cross_channel_norm_layer(input, name=None, param_attr=None,
                             **_compat):
    """Per-position L2 norm across channels with learned per-channel
    scale (CrossChannelNormLayer, the SSD conv4_3 norm)."""
    from .layer_helper import LayerHelper
    v = _materialize_dense(input)
    helper = LayerHelper("cc_norm", name=name)
    C = int(v.shape[1])
    scale = helper.create_parameter(param_attr or ParamAttr(), [C],
                                    "float32")
    normed = flayers.l2_normalize(v, axis=1)
    sc = flayers.reshape(scale, shape=[1, C, 1, 1])
    return flayers.elementwise_mul(normed, sc)


def roi_pool_layer(input, rois, pooled_width, pooled_height,
                   spatial_scale, name=None, **_compat):
    v = _materialize_dense(input)
    r = _materialize_dense(rois)
    return _append1("roi_pool",
                    {"X": [v.name], "ROIs": [r.name]},
                    {"pooled_height": int(pooled_height),
                     "pooled_width": int(pooled_width),
                     "spatial_scale": float(spatial_scale)},
                    name=name, dtype=v.dtype, n_out=2,
                    out_slots=("Out", "Argmax"))[0]


def spp_layer(input, num_channels=None, pyramid_height=3,
              pool_type=None, name=None, **_compat):
    v = _materialize_dense(input)
    kind = {"max": "max", "avg": "avg"}.get(
        getattr(pool_type, "kind", "max"), "max")
    return _append1("spp", {"X": [v.name]},
                    {"pyramid_height": int(pyramid_height),
                     "pooling_type": kind}, name=name, dtype=v.dtype)


# -- 3D conv/pool ------------------------------------------------------------

def img_conv3d_layer(input, filter_size, num_filters, num_channels=None,
                     stride=1, padding=0, act=None, param_attr=None,
                     bias_attr=True, name=None, **_compat):
    from .layer_helper import LayerHelper
    v = _materialize_dense(input)
    helper = LayerHelper("conv3d", name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 3
    s = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    cin = num_channels or int(v.shape[1])
    w = helper.create_parameter(param_attr or ParamAttr(),
                                [int(num_filters), cin] + [int(x) for x
                                                           in k],
                                "float32")
    out = helper.create_tmp_variable(v.dtype)
    helper.append_op("conv3d", {"Input": [v.name], "Filter": [w.name]},
                     {"Output": [out.name]},
                     {"strides": [int(x) for x in s],
                      "paddings": [int(x) for x in p],
                      "dilations": [1, 1, 1], "groups": 1})
    op = _act_op(act)
    return getattr(flayers, op)(out) if op else out


def img_pool3d_layer(input, pool_size, stride=1, padding=0,
                     pool_type=None, name=None, **_compat):
    v = _materialize_dense(input)
    kind = {"max": "max", "avg": "avg"}.get(
        getattr(pool_type, "kind", "max"), "max")
    k = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size] * 3
    s = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    return _append1("pool3d", {"X": [v.name]},
                    {"pooling_type": kind,
                     "ksize": [int(x) for x in k],
                     "strides": [int(x) for x in s],
                     "paddings": [int(x) for x in p]},
                    name=name, dtype=v.dtype)


# -- sequence tail -----------------------------------------------------------

def seq_slice_layer(input, starts, ends, name=None, **_compat):
    """Per-sample sequence slicing (SequenceSliceLayer.cpp:117-151):
    start/end index LAYERS (one row of up to K indices per
    (sub-)sequence, -1 ends a row's selection) cut spans out of the
    input. Output is a NESTED sequence: one sub-sequence slot per
    (row, k), length 0 where unselected."""
    from .layer_helper import LayerHelper
    v = _materialize_seq(input)
    blk = default_main_program().current_block()
    nested = v.lod_level == 2 and v.sub_seq_len_var
    if not nested and (v.lod_level != 1 or not v.seq_len_var):
        raise ValueError("seq_slice_layer expects a sequence input")
    inner = blk._find_var(v.sub_seq_len_var if nested
                          else v.seq_len_var)
    op_ins = {"X": [v.name], "InnerLens": [inner.name]}
    got_idx = False
    for slot, idx in (("Starts", starts), ("Ends", ends)):
        if idx is None:
            continue
        op_ins[slot] = [_materialize_dense(idx).name]
        got_idx = True
    if not got_idx:
        raise ValueError("seq_slice_layer: at least one of starts/ends "
                         "must be given")
    helper = LayerHelper("seq_slice", name=name)
    out = helper.create_tmp_variable(v.dtype)
    o_inner = helper.create_tmp_variable("int64")
    o_outer = helper.create_tmp_variable("int64")
    helper.append_op("seq_slice", op_ins,
                     {"Out": [out.name], "OutInner": [o_inner.name],
                      "OutOuter": [o_outer.name]}, {})
    out.lod_level = 2
    out.seq_len_var = o_outer.name
    out.sub_seq_len_var = o_inner.name
    return out


def sub_seq_layer(input, offsets, sizes, name=None, **_compat):
    """Slice every sequence at (offset, size) — scalars or per-sample
    LAYERS (legacy SubSequenceLayer). The per-sample form rides the
    seq_slice op (starts=offset, ends=offset+size-1) and returns one
    sub-sequence per example."""
    if not isinstance(offsets, int) or not isinstance(sizes, int):
        off = _materialize_dense(offsets)
        size = _materialize_dense(sizes)
        off_f = flayers.cast(off, "float32")
        end_f = flayers.elementwise_add(off_f,
                                        flayers.cast(size, "float32"))
        ends = flayers.scale(end_f, scale=1.0, bias=-1.0)
        nested = seq_slice_layer(input=input, starts=off, ends=ends,
                                 name=name)
        # one slice per sequence: collapse the K=1 nesting back to a
        # plain sequence
        v = nested
        blk = default_main_program().current_block()
        inner = blk._find_var(v.sub_seq_len_var)
        out = flayers.squeeze(v, axes=[1])
        out.lod_level = 1
        lens = flayers.squeeze(inner, axes=[1])
        out.seq_len_var = lens.name
        return out
    v = _materialize_dense(input)
    out = _append1("sequence_slice", {"X": [v.name]},
                   {"offset": int(offsets), "length": int(sizes)},
                   name=name, dtype=v.dtype)
    out.lod_level = 1
    # the slice narrows the time axis: lengths become
    # clip(len - offset, 0, length)
    blk = default_main_program().current_block()
    lens = blk._find_var(v.seq_len_var) or blk.create_var(
        name=v.seq_len_var, shape=(-1,), dtype="int64")
    off_c = flayers.fill_constant([1], "int64", int(offsets))
    len_c = flayers.fill_constant([1], "int64", int(sizes))
    zero = flayers.fill_constant([1], "int64", 0)
    shifted = flayers.elementwise_sub(lens, off_c)
    clipped = flayers.elementwise_min(
        flayers.elementwise_max(shifted, zero), len_c)
    out.seq_len_var = clipped.name
    return out


def _materialize_seq(x, level=1):
    """Like _materialize_dense but a bare data_layer handle becomes a
    padded SEQUENCE var (the beam-training layers consume sequences by
    contract; the provider's input_types win when present)."""
    x = _unwrap(x)
    if isinstance(x, _DataHandle):
        if x.var is None:
            hint = x._provider_seq_level()
            x.var = flayers.data(name=x.name, shape=[x.size],
                                 dtype="float32",
                                 lod_level=hint or level)
        return x.var
    return x


def kmax_seq_score_layer(input, beam_size=1, name=None, **_compat):
    """Ids of the top-k scores within each (sub-)sequence
    (KmaxSeqScoreLayer.cpp:41-60): k = min(beam_size, seq_len), and the
    unused tail slots are -1 — the stop marker the beam-training layers
    (sub_nested_seq / seq_slice / cross_entropy_over_beam) key on.
    Level-1 input -> ids [B, K]; nested input -> ids [B, S, K]."""
    v = _materialize_seq(input)
    blk = default_main_program().current_block()
    nested = v.lod_level == 2 and v.sub_seq_len_var
    lens = blk._find_var(v.sub_seq_len_var if nested else v.seq_len_var)
    out = _append1("kmax_seq_score", {"X": [v.name], "Lens": [lens.name]},
                   {"beam_size": int(beam_size)}, name=name,
                   dtype="int64")
    return out


__all__ += [
    "AggregateLevel", "ExpandLevel", "LayerType", "LayerOutput",
    "layer_support", "get_output_layer",
    "square_error_cost", "smooth_l1_cost", "huber_classification_cost",
    "cross_entropy_with_selfnorm",
    "l2_distance_layer", "dot_prod_layer", "out_prod_layer",
    "linear_comb_layer", "convex_comb_layer", "sum_to_one_norm_layer",
    "row_l2_norm_layer", "clip_layer", "resize_layer",
    "scale_shift_layer", "factorization_machine", "gated_unit_layer",
    "selective_fc_layer",
    "pad_layer", "crop_layer", "multiplex_layer", "prelu_layer",
    "row_conv_layer", "bilinear_interp_layer", "rotate_layer",
    "switch_order_layer", "maxid_layer", "sampling_id_layer",
    "eos_layer", "print_layer", "printer_layer",
    "priorbox_layer", "multibox_loss_layer", "detection_output_layer",
    "cross_channel_norm_layer", "roi_pool_layer", "spp_layer",
    "img_conv3d_layer", "img_pool3d_layer",
    "seq_slice_layer", "sub_seq_layer", "kmax_seq_score_layer",
]


# -- step layers / recurrent tail -------------------------------------------

def recurrent_layer(input, act=None, bias_attr=False, param_attr=None,
                    reverse=False, name=None, **_compat):
    """Legacy RecurrentLayer: out[t] = act(in[t] + W out[t-1]) over a
    pre-projected sequence — exactly the simple_rnn op."""
    v = _materialize_dense(input)
    return flayers.simple_rnn(v, int(v.shape[-1]),
                              param_attr=param_attr,
                              act=_act_op(act) or "tanh",
                              is_reverse=reverse, name=name)


def lstm_step_layer(input, state, size=None, act=None, gate_act=None,
                    state_act=None, bias_attr=None, name=None, **_compat):
    """One LSTM step inside a recurrent_group (LSTMStepLayer): `input`
    carries the 4 pre-projected gates, `state` the previous cell.
    Returns the hidden; the new cell rides as `.step_state` for
    get_output_layer(arg_name='state')."""
    from .framework import unique_name
    gates = _materialize_dense(input)
    c_prev = _materialize_dense(state)
    blk = default_main_program().current_block()
    cvar = blk.create_var(name=unique_name((name or "lstm_step") + "@c"))
    hvar = blk.create_var(name=unique_name((name or "lstm_step") + ".out"))
    blk.append_op("lstm_unit", {"X": [gates.name], "C_prev": [c_prev.name]},
                  {"C": [cvar.name], "H": [hvar.name]},
                  {"forget_bias": 0.0})
    default_main_program().bump()
    hvar.step_state = cvar
    return hvar


def gru_step_layer(input, output_mem, size=None, act=None, gate_act=None,
                   param_attr=None, bias_attr=None, name=None, **_compat):
    """One GRU step inside a recurrent_group (GruStepLayer): `input` is
    [B, 3*size] pre-projected, `output_mem` the previous hidden; the
    recurrent weight lives in the step op."""
    from .framework import unique_name
    from .layer_helper import LayerHelper
    x3 = _materialize_dense(input)
    h = _materialize_dense(output_mem)
    size = int(size or int(x3.shape[-1]) // 3)
    helper = LayerHelper(name or "gru_step")
    w = helper.create_parameter(param_attr or ParamAttr(),
                                [size, size * 3], "float32")
    blk = default_main_program().current_block()
    gate = blk.create_var(name=unique_name((name or "gru_step") + "@g"))
    rhp = blk.create_var(name=unique_name((name or "gru_step") + "@r"))
    # '<name>.' prefix so memory(name=...) finds this step output (the
    # legacy layer-name linkage _resolve_link matches on)
    hvar = blk.create_var(name=unique_name((name or "gru_step") + ".out"))
    ins = {"Input": [x3.name], "HiddenPrev": [h.name], "Weight": [w.name]}
    if bias_attr is not False and bias_attr is not None:
        b = helper.create_parameter(
            bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr(),
            [1, size * 3], "float32", is_bias=True)
        ins["Bias"] = [b.name]
    blk.append_op("gru_unit", ins,
                  {"Gate": [gate.name], "ResetHiddenPrev": [rhp.name],
                   "Hidden": [hvar.name]},
                  {"gate_activation": _act_op_or(gate_act, "sigmoid"),
                   "activation": _act_op_or(act, "tanh")})
    default_main_program().bump()
    return hvar


gru_step_naive_layer = gru_step_layer   # same math, no fused kernel here


def scale_sub_region_layer(input, indices, value, name=None, **_compat):
    v = _materialize_dense(input)
    idx = _materialize_dense(indices)
    return _append1("scale_sub_region",
                    {"X": [v.name], "Indices": [idx.name]},
                    {"value": float(value)}, name=name, dtype=v.dtype)


class BaseGeneratedInput:
    pass


class GeneratedInput(BaseGeneratedInput):
    """The feedback slot of the legacy generation API: each step
    receives the EMBEDDING (table `embedding_name`, width
    `embedding_size`) of the previously generated word
    (trainer_config_helpers layers.py GeneratedInput)."""

    def __init__(self, size, embedding_name, embedding_size, **_compat):
        self.size = int(size)
        self.embedding_name = embedding_name
        self.embedding_size = int(embedding_size)


def beam_search(step, input, bos_id, eos_id, beam_size=1,
                max_length=100, num_results_per_sample=None, name=None,
                **_compat):
    """Legacy in-config generation (layers.py beam_search ->
    RecurrentGradientMachine::generateSequence/beamSearch): traces the
    user step net once into a sub-block and lowers the whole generate
    loop to one op (ops/beam_ops.py legacy_beam_generate).
    Returns the ranked sentence-ids var, registered under the legacy
    output name `__beam_search_predict__`; `.scores_var`/`.lens_var`
    carry the companions."""
    from .framework import unique_name
    from .layer_helper import LayerHelper
    from .layers import rnn_group as rg

    inputs = input if isinstance(input, (list, tuple)) else [input]
    gen = [i for i in inputs if isinstance(i, BaseGeneratedInput)]
    if len(gen) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput")
    gen = gen[0]

    program = default_main_program()
    parent = program.current_block()
    helper = LayerHelper(name or "beam_search")
    emb_table = helper.create_parameter(
        ParamAttr(name=gen.embedding_name),
        [gen.size, gen.embedding_size], "float32")

    sub = program.create_block()
    g = rg._GroupTrace(sub)
    rg._ACTIVE.append(g)
    step_args = []
    try:
        for i in inputs:
            if isinstance(i, BaseGeneratedInput):
                ph = sub.create_var(
                    name=unique_name("gen_word@emb"),
                    shape=(-1, gen.embedding_size), dtype="float32")
                emb_step_name = ph.name
                step_args.append(ph)
            elif isinstance(i, (StaticInput, SubsequenceInput)):
                step_args.append(_materialize_dense(i.var)
                                 if not isinstance(i.var, _DataHandle)
                                 else i.var.as_dense())
            else:
                step_args.append(_materialize_dense(i))
        out = step(*step_args)
    finally:
        rg._ACTIVE.pop()
        program.rollback()
    out = _materialize_dense(_unwrap(out))

    mem_names, feedbacks, boots = [], [], []
    for ph, link_name, boot_layer in g.memories:
        mem_names.append(ph.name)
        feedbacks.append(rg._resolve_link(sub, link_name, [out]))
        if boot_layer is not None:
            boots.append(boot_layer)
        else:
            bvar = parent.create_var(
                name=unique_name(f"{link_name}@boot"), stop_gradient=True)
            ref = next((a for a in step_args
                        if getattr(a, "name", None) is not None
                        and a.name != emb_step_name
                        and getattr(a, "block", None) is not sub), None)
            if ref is None:
                raise ValueError("beam_search memory without boot_layer "
                                 "needs a StaticInput to size the batch")
            parent.append_op(
                "fill_constant_batch_size_like",
                {"Input": [ref.name]}, {"Out": [bvar.name]},
                {"shape": [-1, int(ph.shape[-1])], "value": 0.0,
                 "dtype": "float32", "input_dim_idx": 0,
                 "output_dim_idx": 0})
            boots.append(bvar)

    from .layers.control_flow import _block_reads_writes, _ancestor_var
    reads, _w = _block_reads_writes(program, sub)
    managed = set(mem_names) | {emb_step_name}
    captured = [n for n in reads
                if n not in managed
                and _ancestor_var(parent, n) is not None]
    # parameters/persistables are batch-independent (NOT tiled per
    # beam); batch-shaped captures are repeated K times per row
    const_names = [n for n in captured
                   if getattr(_ancestor_var(parent, n), "persistable",
                              False)]
    x_names = [n for n in captured if n not in const_names]

    static_vars = [a for a in step_args
                   if getattr(a, "name", None) is not None
                   and a.name != emb_step_name
                   and a.block is not sub]
    R = min(int(num_results_per_sample or beam_size), int(beam_size))
    ids_var = parent.create_var(name="__beam_search_predict__",
                                dtype="int64",
                                shape=(-1, R, int(max_length)))
    scores_var = parent.create_var(name=unique_name("beam@scores"),
                                   shape=(-1, R))
    lens_var = parent.create_var(name=unique_name("beam@lens"),
                                 dtype="int64", shape=(-1, R))
    parent.append_op(
        "legacy_beam_generate",
        {"X": x_names, "Xc": const_names,
         "Boot": [b.name for b in boots],
         "BatchRef": [v.name for v in static_vars[:1]],
         "Emb": [emb_table.name]},
        {"SentenceIds": [ids_var.name],
         "SentenceScores": [scores_var.name],
         "SentenceLens": [lens_var.name]},
        {"sub_block": sub.idx, "x_names": x_names,
         "const_names": const_names,
         "emb_step_name": emb_step_name,
         "mem_names": mem_names, "mem_feedback": feedbacks,
         "out_name": out.name, "bos_id": int(bos_id),
         "end_id": int(eos_id), "beam_size": int(beam_size),
         "num_results": R,
         "max_length": int(max_length)},
        infer_shape=False)
    program.bump()
    ids_var.scores_var = scores_var
    ids_var.lens_var = lens_var
    ids_var.num_results = R
    return ids_var


def cross_entropy_over_beam(input, name=None, **_compat):
    """Beam-level softmax cross entropy for learning-to-search training
    (reference layers.py:6386 / CrossEntropyOverBeam.cpp): `input` is a
    list of BeamInput(candidate_scores, selected_candidates, gold)
    triples, one per beam expansion — step 0 a plain score sequence,
    later steps nested score sequences whose rows are spawned by the
    previous step's selections. Lowers onto the host-side
    cross_entropy_over_beam op (ops/beam_ops.py)."""
    from .layer_helper import LayerHelper
    beams = [input] if isinstance(input, BeamInput) else list(input)
    blk = default_main_program().current_block()
    op_ins = {"Scores": [], "RowLens": [], "Ids": [], "Gold": []}
    beam_size = None
    for b in beams:
        cs = _materialize_seq(b.candidate_scores)
        ids = _materialize_dense(b.selected_candidates)
        gold = _materialize_dense(b.gold)
        if beam_size is None:
            beam_size = int(ids.shape[-1])
        nested = cs.lod_level == 2 and cs.sub_seq_len_var
        rl = blk._find_var(cs.sub_seq_len_var if nested
                           else cs.seq_len_var)
        op_ins["Scores"].append(cs.name)
        op_ins["RowLens"].append(rl.name)
        op_ins["Ids"].append(ids.name)
        op_ins["Gold"].append(gold.name)
    helper = LayerHelper("cross_entropy_over_beam", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("cross_entropy_over_beam", op_ins,
                     {"Out": [out.name]},
                     {"num_expansions": len(beams),
                      "beam_size": beam_size})
    return flayers.mean(out)


class BeamInput:
    """One beam expansion for cross_entropy_over_beam (reference
    layers.py:6360): scores over all candidates, the top-k selected
    candidate ids, and the gold index."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def conv_operator(img, filter, filter_size, num_filters,  # noqa: A002
                  num_channels=None, stride=1, padding=0,
                  filter_size_y=None, stride_y=None, padding_y=None,
                  **_compat):
    """Per-sample dynamic-filter conv inside mixed_layer (gserver
    ConvOperator): `filter` is a LAYER whose rows hold each sample's
    own kernel. Lowers to the vmapped dynamic_conv2d op; rectangular
    kernels/strides follow the legacy *_y arguments."""
    def build(size):
        x = _as_image(img, num_channels)
        f = _materialize_dense(filter)
        C = num_channels or int(x.shape[1])
        attrs = {"num_filters": int(num_filters),
                 "num_channels": int(C),
                 "kw": int(filter_size),
                 "kh": int(filter_size_y if filter_size_y is not None
                           else filter_size),
                 "sw": int(stride),
                 "sh": int(stride_y if stride_y is not None else stride),
                 "pw": int(padding),
                 "ph": int(padding_y if padding_y is not None
                           else padding)}
        return _append1("dynamic_conv2d",
                        {"X": [x.name], "Filter": [f.name]}, attrs)
    return _ProjectionSpec(build)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None,
                **_compat):
    """LambdaRank cost over per-query sequences (gserver
    LambdaCost.cpp): `input` is the MODEL's score sequence (the
    gradient-receiving input, LambdaCost input 0 — mq2007's
    lambda_cost(input=output, score=label)), `score` the ground-truth
    relevance. The pair set, max_sort_size truncation and gradient
    field match the C++ exactly (ops/misc_ops.py lambda_rank_cost);
    the NDCG weights come from an in-graph argsort.

    Reported-value divergence (gradients match exactly): the returned
    cost is the mean surrogate pairwise log-loss, while the reference
    layer's FORWARD value is the per-query NDCG (CostLayer.cpp:363-390)
    — so this value is not comparable to legacy training logs. The
    reference's observable is exposed as `.ndcg` on the returned var
    (mean NDCG@NDCG_num, stop-gradient), fetchable per batch."""
    if max_sort_size != -1 and max_sort_size < NDCG_num:
        raise ValueError("lambda_cost: max_sort_size must be -1 or "
                         ">= NDCG_num (LambdaCost::init)")
    sc = _materialize_dense(input)      # model scores
    lab = _materialize_dense(score)    # relevance labels
    if sc.lod_level < 1:
        raise ValueError("lambda_cost expects sequence inputs (one "
                         "query's documents per sequence)")
    def flat(v):
        if len(v.shape) >= 3:
            out = flayers.squeeze(v, axes=[2])
            out.lod_level = 1
            out.seq_len_var = v.seq_len_var
            return out
        return v
    sc2, lab2 = flat(sc), flat(lab)
    cost, _ndcg = _append1("lambda_rank_cost",
                           {"Score": [sc2.name], "Label": [lab2.name],
                            "SeqLen": [sc2.seq_len_var]},
                           {"NDCG_num": int(NDCG_num),
                            "max_sort_size": int(max_sort_size)},
                           name=name, n_out=2, out_slots=("Out", "Ndcg"))
    ret = flayers.mean(cost)
    ret.ndcg = flayers.mean(_ndcg)     # the reference's forward value
    return ret


def sub_nested_seq_layer(input, selected_indices, name=None, **_compat):
    """Select whole sub-sequences of a nested sequence by per-example
    index rows (SubNestedSequenceLayer.cpp:97-120; -1 stops a row's
    selection). Output is nested: one slot per selection, gathered
    in-graph so gradients flow back through the gather."""
    from .layer_helper import LayerHelper
    v = _materialize_seq(input, level=2)
    if v.lod_level != 2 or not v.sub_seq_len_var:
        raise ValueError("sub_nested_seq_layer expects a NESTED sequence "
                         "input (lod_level=2)")
    ids = _materialize_dense(selected_indices)
    helper = LayerHelper("sub_nested_seq", name=name)
    out = helper.create_tmp_variable(v.dtype)
    o_inner = helper.create_tmp_variable("int64")
    o_outer = helper.create_tmp_variable("int64")
    helper.append_op("sub_nested_seq",
                     {"X": [v.name], "InnerLens": [v.sub_seq_len_var],
                      "Ids": [ids.name]},
                     {"Out": [out.name], "OutInner": [o_inner.name],
                      "OutOuter": [o_outer.name]}, {})
    out.lod_level = 2
    out.seq_len_var = o_outer.name
    out.sub_seq_len_var = o_inner.name
    return out


__all__ += [
    "recurrent_layer", "lstm_step_layer", "gru_step_layer",
    "gru_step_naive_layer", "scale_sub_region_layer",
    "beam_search", "cross_entropy_over_beam", "GeneratedInput",
    "BaseGeneratedInput", "BeamInput", "conv_operator", "lambda_cost",
    "sub_nested_seq_layer", "Inputs", "Outputs",
    "seqtext_printer_evaluator",
]


# ---------------------------------------------------------------------------
# networks.py helper tail (reference trainer_config_helpers/networks.py)
# ---------------------------------------------------------------------------

def inputs(*layers, **_compat):
    """Declares the input order (reference networks.inputs); our feed
    order is the data-layer declaration order, so this is a no-op
    marker kept for config compatibility."""
    return None


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0,
                   pool_stride=1, pool_type=None, param_attr=None,
                   **_compat):
    """Conv[+BN+dropout] stack closed by one pool (networks.py:336 —
    the VGG building block)."""
    n = len(conv_num_filter)
    def bcast(v):
        return v if isinstance(v, (list, tuple)) else [v] * n
    pads = bcast(conv_padding)
    ks = bcast(conv_filter_size)
    acts = bcast(conv_act)
    bns = bcast(conv_with_batchnorm)
    drops = bcast(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = img_conv_layer(input=tmp, filter_size=ks[i],
                             num_filters=conv_num_filter[i],
                             num_channels=(num_channels if i == 0
                                           else None),
                             stride=1, padding=pads[i],
                             act=None if bns[i] else acts[i],
                             param_attr=param_attr)
        if bns[i]:
            tmp = batch_norm_layer(input=tmp, act=acts[i])
            if drops[i]:
                tmp = dropout_layer(input=tmp, dropout_rate=drops[i])
    return img_pool_layer(input=tmp, pool_size=pool_size,
                          stride=pool_stride,
                          pool_type=pool_type or MaxPooling())


def small_vgg(input_image, num_channels, num_classes, **_compat):
    """networks.py:517 — the CIFAR VGG."""
    def block(ipt, nf, times, dropouts, nc=None):
        return img_conv_group(input=ipt, num_channels=nc, pool_size=2,
                              pool_stride=2, conv_num_filter=[nf] * times,
                              conv_filter_size=3,
                              conv_act=ReluActivation(),
                              conv_with_batchnorm=True,
                              conv_batchnorm_drop_rate=dropouts,
                              pool_type=MaxPooling())
    tmp = block(input_image, 64, 2, [0.3, 0], num_channels)
    tmp = block(tmp, 128, 2, [0.4, 0])
    tmp = block(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = block(tmp, 512, 3, [0.4, 0.4, 0])
    tmp = img_pool_layer(input=tmp, stride=2, pool_size=2,
                         pool_type=MaxPooling())
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = fc_layer(input=tmp, size=512, act=LinearActivation())
    tmp = batch_norm_layer(input=tmp, act=ReluActivation())
    return fc_layer(input=tmp, size=num_classes,
                    act=SoftmaxActivation())


def vgg_16_network(input_image, num_channels, num_classes=1000,
                   **_compat):
    """networks.py vgg_16_network: the 5-block VGG-16."""
    def block(ipt, nf, times, nc=None):
        return img_conv_group(input=ipt, num_channels=nc, pool_size=2,
                              pool_stride=2, conv_num_filter=[nf] * times,
                              conv_filter_size=3,
                              conv_act=ReluActivation(),
                              pool_type=MaxPooling())
    tmp = block(input_image, 64, 2, num_channels)
    tmp = block(tmp, 128, 2)
    tmp = block(tmp, 256, 3)
    tmp = block(tmp, 512, 3)
    tmp = block(tmp, 512, 3)
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5))
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5))
    return fc_layer(input=tmp, size=num_classes,
                    act=SoftmaxActivation())


def img_separable_conv(input, num_channels, num_out_channels,
                       filter_size, stride=1, padding=None, act=None,
                       bias_attr=True, param_attr=None, shared_bias=True,
                       name=None, **_compat):
    """Depthwise + pointwise conv pair (networks.img_separable_conv)."""
    dw = img_conv_layer(input=input, filter_size=filter_size,
                        num_filters=num_channels,
                        num_channels=num_channels, stride=stride,
                        padding=(padding if padding is not None
                                 else (filter_size - 1) // 2),
                        act=None, groups=num_channels,
                        param_attr=param_attr)
    return img_conv_layer(input=dw, filter_size=1,
                          num_filters=num_out_channels, stride=1,
                          padding=0, act=act, param_attr=param_attr)


def text_conv_pool(input, context_len, hidden_size, act=None, **_compat):
    """context window conv + max pool over time (networks.text_conv_pool
    == sequence_conv_pool)."""
    proj = context_projection(input=input, context_len=context_len)
    hid = fc_layer(input=proj, size=hidden_size,
                   act=act or ReluActivation())
    return pooling_layer(input=hid, pooling_type=MaxPooling())


sequence_conv_pool = text_conv_pool


def gru_unit(input, size=None, name=None, gru_param_attr=None,
             act=None, gate_act=None, out_memory=None,
             gru_layer_attr=None, naive=False, memory_boot=None,
             **_compat):
    """Single GRU step with its own output memory, for use inside a
    recurrent_group step (networks.py:940)."""
    from .framework import unique_name
    x3 = _materialize_dense(input)
    size = int(size or int(x3.shape[-1]) // 3)
    gname = name or unique_name("gru_unit")
    if out_memory is not None:
        h = _unwrap(out_memory)
    else:
        h = memory(name=gname, size=size, boot_layer=memory_boot)
    return gru_step_layer(input=x3, output_mem=h, size=size, name=gname,
                          act=act, gate_act=gate_act,
                          param_attr=gru_param_attr)


def lstmemory_unit(input, size=None, name=None, out_memory=None,
                   input_proj_bias_attr=None, input_proj_layer_attr=None,
                   lstm_param_attr=None, lstm_bias_attr=None, act=None,
                   gate_act=None, state_act=None, memory_boot=None,
                   **_compat):
    """Single LSTM step: project input+state to 4 gates, one lstm_unit
    (networks.py:717), with hidden/cell memories linked by name."""
    from .framework import unique_name
    x = _materialize_dense(input)
    size = int(size or int(x.shape[-1]) // 4)
    gname = name or unique_name("lstmemory_unit")
    if out_memory is not None:
        h = _unwrap(out_memory)
    else:
        h = memory(name=gname, size=size, boot_layer=memory_boot)
    c = memory(name=gname + "@c", size=size)
    blk = default_main_program().current_block()
    rec = flayers.fc(h, size * 4, bias_attr=False,
                     param_attr=lstm_param_attr)
    xp = flayers.fc(x, size * 4, bias_attr=input_proj_bias_attr
                    if input_proj_bias_attr is not None else True)
    gates = flayers.elementwise_add(xp, rec)
    cvar = blk.create_var(name=unique_name(gname + "@c.step"))
    hvar = blk.create_var(name=unique_name(gname + ".step"))
    blk.append_op("lstm_unit", {"X": [gates.name], "C_prev": [c.name]},
                  {"C": [cvar.name], "H": [hvar.name]},
                  {"forget_bias": 0.0})
    default_main_program().bump()
    hvar.step_state = cvar
    return hvar


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None, **_compat):
    """Bahdanau-style additive attention for recurrent_group steps
    (networks.py:1400): softmax_j( v . f(W s + U h_j) ) weighted sum of
    the encoded sequence. encoded_sequence/encoded_proj arrive as
    StaticInputs ([B, T, H] each step); padded keys are masked through
    sequence_softmax."""
    seq = _unwrap(encoded_sequence)
    proj = _unwrap(encoded_proj)
    state = _unwrap(decoder_state)
    P = int(proj.shape[-1])
    sp = flayers.fc(state, P, bias_attr=False,
                    param_attr=transform_param_attr)        # [B, P]
    sp3 = flayers.reshape(sp, shape=[-1, 1, P])
    act_name = _act_op(weight_act) or "tanh"
    m = getattr(flayers, act_name)(flayers.elementwise_add(proj, sp3))
    # no shape inference runs inside step sub-blocks; stamp what fc's
    # flattening needs (T stays dynamic, only the tail matters)
    m.shape = (-1, -1, P)
    e = flayers.fc(m, 1, num_flatten_dims=2, bias_attr=False,
                   param_attr=softmax_param_attr)           # [B, T, 1]
    e2 = flayers.squeeze(e, axes=[2])
    e2.lod_level = 1
    e2.seq_len_var = seq.seq_len_var
    a = flayers.sequence_softmax(e2)                        # [B, T]
    a3 = flayers.unsqueeze(a, axes=[2])
    ctxv = flayers.reduce_sum(flayers.elementwise_mul(seq, a3), dim=[1])
    ctxv.shape = (-1, int(seq.shape[-1]))   # no shape infer in sub-blocks
    return ctxv


def dot_product_attention(attended_sequence, attending_sequence,
                          transformed_state, softmax_param_attr=None,
                          name=None, **_compat):
    """networks.dot_product_attention: scores = <h_j, s> over the
    attending sequence, weighted sum of the attended one."""
    att = _unwrap(attended_sequence)
    ing = _unwrap(attending_sequence)
    state = _unwrap(transformed_state)
    D = int(ing.shape[-1])
    s3 = flayers.reshape(state, shape=[-1, 1, D])
    e = flayers.reduce_sum(flayers.elementwise_mul(ing, s3), dim=[2])
    e.lod_level = 1
    e.seq_len_var = att.seq_len_var
    a = flayers.sequence_softmax(e)
    a3 = flayers.unsqueeze(a, axes=[2])
    ctxv = flayers.reduce_sum(flayers.elementwise_mul(att, a3), dim=[1])
    ctxv.shape = (-1, int(att.shape[-1]))
    return ctxv


def simple_gru2(input, size, name=None, reverse=False, act=None,
                gate_act=None, **_compat):
    """networks.simple_gru2 — same math as simple_gru, different param
    grouping in the reference; one fused recurrence here."""
    return grumemory(fc_layer(input, size * 3, bias_attr=True),
                     size=size, reverse=reverse, act=act,
                     gate_act=gate_act, name=name)


def bidirectional_gru(input, size, return_seq=False, name=None,
                      **_compat):
    fwd = simple_gru2(input, size)
    bwd = simple_gru2(input, size, reverse=True)
    if return_seq:
        out = flayers.concat([fwd, bwd], axis=2)
        out.lod_level = fwd.lod_level
        out.seq_len_var = fwd.seq_len_var
        return out
    return flayers.concat([flayers.sequence_last_step(fwd),
                           flayers.sequence_first_step(bwd)], axis=1)


def multi_head_attention(query, key, value, key_proj_size, value_proj_size,
                         head_num, attention_type="dot-product attention",
                         softmax_param_attr=None, name=None, **_compat):
    """networks.multi_head_attention (reference networks.py:1580-1704).
    The dot-product form lowers onto the fused sdpa op (causal off;
    per-step query [B, H]); the additive form composes per head as
    tanh(q_i + k_i) -> fc(1) -> sequence softmax -> weighted sum, the
    reference's mixed-layer circuit."""
    if attention_type not in ("dot-product attention",
                              "additive attention"):
        raise ValueError("multi_head_attention: attention_type must be "
                         "'dot-product attention' or 'additive "
                         "attention'")
    q = _unwrap(query)
    k = _unwrap(key)
    v = _unwrap(value)
    KP, VP = int(key_proj_size), int(value_proj_size)
    kp = flayers.fc(k, KP * head_num, num_flatten_dims=2,
                    bias_attr=False)
    vp = flayers.fc(v, VP * head_num, num_flatten_dims=2,
                    bias_attr=False)
    qp = flayers.fc(q, KP * head_num, bias_attr=False)
    if "dot" in attention_type:
        q3 = flayers.reshape(qp, shape=[-1, 1, KP * head_num])
        out = flayers.scaled_dot_product_attention(q3, kp, vp,
                                                   num_heads=head_num)
        return flayers.reshape(out, shape=[-1, VP * head_num])

    # additive: per head, m = tanh(sub_query + sub_key), weight =
    # sequence-softmax(fc(m)), head = sum_t weight_t * sub_value_t
    q3 = flayers.reshape(qp, shape=[-1, 1, KP * head_num])
    heads = []
    for i in range(head_num):
        kp_i = flayers.slice(kp, axes=[2], starts=[i * KP],
                             ends=[(i + 1) * KP])
        vp_i = flayers.slice(vp, axes=[2], starts=[i * VP],
                             ends=[(i + 1) * VP])
        qp_i = flayers.slice(q3, axes=[2], starts=[i * KP],
                             ends=[(i + 1) * KP])
        m = flayers.tanh(flayers.elementwise_add(kp_i, qp_i))
        m.shape = (-1, -1, KP)
        e = flayers.fc(m, 1, num_flatten_dims=2, bias_attr=False,
                       param_attr=softmax_param_attr)       # [B, T, 1]
        e2 = flayers.squeeze(e, axes=[2])
        e2.lod_level = 1
        e2.seq_len_var = k.seq_len_var
        a = flayers.sequence_softmax(e2)                    # [B, T]
        a3 = flayers.unsqueeze(a, axes=[2])
        h = flayers.reduce_sum(flayers.elementwise_mul(vp_i, a3),
                               dim=[1])
        h.shape = (-1, VP)
        heads.append(h)
    return heads[0] if head_num == 1 else flayers.concat(heads, axis=1)


__all__ += [
    "inputs", "img_conv_group", "small_vgg", "vgg_16_network",
    "img_separable_conv", "text_conv_pool", "sequence_conv_pool",
    "gru_unit", "lstmemory_unit", "simple_attention",
    "dot_product_attention", "simple_gru2", "bidirectional_gru",
    "multi_head_attention",
]
