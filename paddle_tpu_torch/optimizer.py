"""Optimizers: append backward + update ops (the port's copy of
`paddle_tpu/optimizer.py`: SGD, Momentum, Adagrad, DecayedAdagrad,
Adam, Adamax, Adadelta, RMSProp, Ftrl and ModelAverage).

`minimize(loss)` appends the grad ops (backward.append_backward), the
regularization and clip ops on the gradients, the pruning masks of
`ParamAttr(update_hooks=...)`, then one update op per parameter plus its
accumulator state vars (persistable, initialized by the startup
program), and the `global_step` increment when one is given — the same
program text as the JAX package. The executor runs the update ops in
place on the scope's tensors (ops/optimizer_ops.py).
"""

from __future__ import annotations

from . import framework
from .backward import append_backward
from .framework import default_main_program, unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    op_type = None

    def __init__(self, learning_rate, regularization=None, global_step=None):
        self._lr = learning_rate
        self.regularization = regularization
        self._global_step = global_step
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
        params_grads = self._append_update_hooks(params_grads)
        lr_var = self._create_lr_var(self.helper)
        self._create_accumulators(list(params_grads))
        ops = [self._append_optimize_op(pg, lr_var) for pg in params_grads]
        # health telemetry (monitor/health.py): the FINAL (param, grad)
        # pairing, after regularization / clip / pruning-mask renames,
        # so the health reductions read the gradients the updates consume
        prog = loss.block.program
        stamped = list(getattr(prog, "_health_param_grads", []) or [])
        stamped.extend((p.name, g.name) for p, g in params_grads)
        prog._health_param_grads = stamped
        if self._global_step is not None:
            self.helper.append_op(
                "increment", {"X": [self._global_step.name]},
                {"Out": [self._global_step.name]}, {"step": 1.0},
                infer_shape=False)
        return ops

    def _append_update_hooks(self, params_grads):
        """ParamAttr update_hooks (the reference's StaticPruningHook): a
        magnitude mask is generated from the INITIALIZED values in the
        startup program (which also masks the values themselves), and
        every gradient is masked before its update op — pruned weights
        start at zero and receive zero updates, so they stay pruned."""
        out = []
        for param, grad in params_grads:
            hooks = [h for h in getattr(param, "update_hooks", None) or []
                     if h.type == "pruning"]
            if not hooks:
                out.append((param, grad))
                continue
            mask = self.helper.create_persistable_var(
                param.name + "@PRUNING_MASK", list(param.shape),
                param.dtype)
            sblock = self.helper.startup_program.global_block()
            sblock.append_op("gen_pruning_mask", {"Param": [param.name]},
                             {"Mask": [mask.name]},
                             {"sparsity_ratio": hooks[0].sparsity_ratio},
                             infer_shape=False)
            sblock.append_op("elementwise_mul",
                             {"X": [param.name], "Y": [mask.name]},
                             {"Out": [param.name]}, {},
                             infer_shape=False)
            self.helper.startup_program.bump()
            block = param.block
            masked = block.create_var(
                name=unique_name(f"{param.name}@GRAD@masked"),
                shape=grad.shape, dtype=grad.dtype)
            block.append_op("elementwise_mul",
                            {"X": [grad.name], "Y": [mask.name]},
                            {"Out": [masked.name]}, {})
            out.append((param, masked))
        return out


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        return self.helper.append_op(
            "sgd",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name]}, {}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        vel = self._get_accumulator("velocity", param)
        return self.helper.append_op(
            "momentum",
            {"Param": [param.name], "Grad": [grad.name],
             "Velocity": [vel.name], "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name], "VelocityOut": [vel.name]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return self.helper.append_op(
            "adagrad",
            {"Param": [param.name], "Grad": [grad.name],
             "Moment": [moment.name], "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name], "MomentOut": [moment.name]},
            {"epsilon": self._epsilon}, infer_shape=False)


class DecayedAdagradOptimizer(AdagradOptimizer):
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, epsilon=epsilon, **kw)
        self._decay = decay

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return self.helper.append_op(
            "decayed_adagrad",
            {"Param": [param.name], "Grad": [grad.name],
             "Moment": [moment.name], "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name], "MomentOut": [moment.name]},
            {"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    op_type = "adam"

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


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        m = self._get_accumulator("moment", param)
        inf = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow", param)
        op = self.helper.append_op(
            "adamax",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [lr_var.name], "Moment": [m.name],
             "InfNorm": [inf.name], "Beta1Pow": [b1p.name]},
            {"ParamOut": [param.name], "MomentOut": [m.name],
             "InfNormOut": [inf.name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon}, infer_shape=False)
        # advance beta1^t after the update (reference keeps a scale op)
        self.helper.append_op(
            "scale", {"X": [b1p.name]}, {"Out": [b1p.name]},
            {"scale": self._beta1}, infer_shape=False)
        return op


class AdadeltaOptimizer(Optimizer):
    op_type = "adadelta"

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        g = self._get_accumulator("avg_squared_grad", param)
        u = self._get_accumulator("avg_squared_update", param)
        return self.helper.append_op(
            "adadelta",
            {"Param": [param.name], "Grad": [grad.name],
             "AvgSquaredGrad": [g.name], "AvgSquaredUpdate": [u.name]},
            {"ParamOut": [param.name], "AvgSquaredGradOut": [g.name],
             "AvgSquaredUpdateOut": [u.name]},
            {"rho": self._rho, "epsilon": self._epsilon}, infer_shape=False)


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"

    def __init__(self, learning_rate, decay=0.9, epsilon=1e-10,
                 momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon, self._momentum = decay, epsilon, momentum

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        ms = self._get_accumulator("mean_square", param)
        mom = self._get_accumulator("moment", param)
        return self.helper.append_op(
            "rmsprop",
            {"Param": [param.name], "Grad": [grad.name],
             "MeanSquare": [ms.name], "Moment": [mom.name],
             "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name], "MeanSquareOut": [ms.name],
             "MomentOut": [mom.name]},
            {"decay": self._decay, "epsilon": self._epsilon,
             "momentum": self._momentum}, infer_shape=False)


class FtrlOptimizer(Optimizer):
    op_type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, param_and_grad, lr_var):
        param, grad = param_and_grad
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return self.helper.append_op(
            "ftrl",
            {"Param": [param.name], "Grad": [grad.name],
             "SquaredAccumulator": [sq.name], "LinearAccumulator": [lin.name],
             "LearningRate": [lr_var.name]},
            {"ParamOut": [param.name], "SquaredAccumOut": [sq.name],
             "LinearAccumOut": [lin.name]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
            infer_shape=False)


# fluid-compatible aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage:
    """Windowed parameter averaging for evaluation (reference
    parameter/AverageOptimizer.h:23; the fluid ModelAverage /
    average_accumulates op keeps the identical three-sum scheme).

    Construct AFTER optimizer.minimize(): appends one
    average_accumulates op per trainable parameter to the training
    program (running sums of post-update values). `apply(exe)` is a
    context manager that swaps the averaged values in (backing up the
    raw ones) for evaluation and restores on exit:

        model_average = ModelAverage(0.15, min_average_window=100,
                                     max_average_window=10000)
        ...train...
        with model_average.apply(exe):
            ...evaluate with averaged weights...
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, program=None,
                 startup_program=None):
        main = program or default_main_program()
        self.helper = LayerHelper("model_average", main_program=main,
                                  startup_program=startup_program)
        self.params = [v for v in main.global_block().vars.values()
                       if getattr(v, "trainable", False)]
        if not self.params:
            raise ValueError("ModelAverage: no trainable parameters — "
                             "construct it after optimizer.minimize()")
        self._vars = {}
        for p in self.params:
            sums = [self.helper.create_persistable_var(
                f"{p.name}@AVG_SUM{i}", list(p.shape), "float32")
                for i in (1, 2, 3)]
            ctrs = [self.helper.create_persistable_var(
                f"{p.name}@AVG_{n}", [1], "int64")
                for n in ("NUM_ACC", "OLD_NUM_ACC", "NUM_UPD")]
            backup = self.helper.create_persistable_var(
                f"{p.name}@AVG_BACKUP", list(p.shape), p.dtype)
            self._vars[p.name] = (sums, ctrs, backup)
            main.global_block().append_op(
                "average_accumulates",
                {"Param": [p.name], "Sum1": [sums[0].name],
                 "Sum2": [sums[1].name], "Sum3": [sums[2].name],
                 "NumAccumulates": [ctrs[0].name],
                 "OldNumAccumulates": [ctrs[1].name],
                 "NumUpdates": [ctrs[2].name]},
                {"Sum1Out": [sums[0].name], "Sum2Out": [sums[1].name],
                 "Sum3Out": [sums[2].name],
                 "NumAccumulatesOut": [ctrs[0].name],
                 "OldNumAccumulatesOut": [ctrs[1].name],
                 "NumUpdatesOut": [ctrs[2].name]},
                {"average_window": float(average_window_rate),
                 "min_average_window": int(min_average_window),
                 "max_average_window": int(max_average_window)},
                infer_shape=False)
        main.bump()
        self.apply_program = self._build_apply()
        self.restore_program = self._build_restore()

    def _declare(self, block, var):
        return block.create_var(name=var.name, shape=var.shape,
                                dtype=var.dtype, persistable=True)

    def _build_apply(self):
        prog = framework.Program()
        block = prog.global_block()
        for p in self.params:
            sums, ctrs, backup = self._vars[p.name]
            for v in (p, *sums, ctrs[0], ctrs[1], backup):
                self._declare(block, v)
            block.append_op(
                "average_apply",
                {"Param": [p.name], "Sum1": [sums[0].name],
                 "Sum2": [sums[1].name], "Sum3": [sums[2].name],
                 "NumAccumulates": [ctrs[0].name],
                 "OldNumAccumulates": [ctrs[1].name]},
                {"Backup": [backup.name], "ParamOut": [p.name]}, {},
                infer_shape=False)
        return prog

    def _build_restore(self):
        prog = framework.Program()
        block = prog.global_block()
        for p in self.params:
            _sums, _ctrs, backup = self._vars[p.name]
            self._declare(block, p)
            self._declare(block, backup)
            block.append_op("assign", {"X": [backup.name]},
                            {"Out": [p.name]}, {}, infer_shape=False)
        return prog

    def apply(self, executor, need_restore=True, scope=None):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            executor.run(self.apply_program, scope=scope)
            try:
                yield
            finally:
                if need_restore:
                    executor.run(self.restore_program, scope=scope)
        return _ctx()

    def restore(self, executor, scope=None):
        executor.run(self.restore_program, scope=scope)
