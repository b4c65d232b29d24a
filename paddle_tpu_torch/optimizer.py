"""Optimizers: append backward + update ops (the port's copy of
`Optimizer`, `SGDOptimizer` and `AdamOptimizer` from
`paddle_tpu/optimizer.py`).

`minimize(loss)` appends the grad ops (backward.append_backward), the
regularization and clip ops on the gradients, then one update op per
parameter plus its accumulator state vars (persistable, initialized by
the startup program) — the same program text as the JAX package. The
executor runs the update ops in place on the scope's tensors
(ops/optimizer_ops.py).
"""

from __future__ import annotations

from . import framework
from .backward import append_backward
from .framework import unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None):
        self._lr = learning_rate
        self.regularization = regularization
        self._accumulators = {}
        self.helper = None

    def _create_lr_var(self, helper):
        if isinstance(self._lr, framework.Variable):
            return self._lr
        name = unique_name("learning_rate")
        return helper.create_persistable_var(
            name, [1], "float32", ConstantInitializer(float(self._lr)))

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        var = self.helper.create_persistable_var(
            unique_name(f"{param.name}_{name}"),
            shape if shape is not None else list(param.shape),
            dtype or param.dtype, ConstantInitializer(fill_value))
        self._accumulators[key] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    def _create_accumulators(self, param_and_grads):
        pass

    def _append_optimize_op(self, param_and_grad, lr_var):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        if not params_grads:
            raise ValueError("no trainable parameters contribute to the loss")
        return self.apply_gradients(loss, params_grads,
                                    startup_program), params_grads

    def apply_gradients(self, loss, params_grads, startup_program=None):
        # ops/state land in the program that owns the loss
        self.helper = LayerHelper(self.__class__.__name__,
                                  main_program=loss.block.program,
                                  startup_program=startup_program)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        from .clip import append_gradient_clip_ops
        params_grads = append_gradient_clip_ops(params_grads)
        lr_var = self._create_lr_var(self.helper)
        self._create_accumulators(list(params_grads))
        return [self._append_optimize_op(pg, lr_var)
                for pg in params_grads]


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        return self.helper.append_op(
            "sgd",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name]}, {}, infer_shape=False)


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return self.helper.append_op(
            "adam",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [lr_var.name], "Moment1": [m1.name],
             "Moment2": [m2.name], "Beta1Pow": [b1p.name],
             "Beta2Pow": [b2p.name]},
            {"ParamOut": [param.name], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon}, infer_shape=False)

