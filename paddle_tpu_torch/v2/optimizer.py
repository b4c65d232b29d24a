"""v2 optimizers (reference python/paddle/v2/optimizer.py wrapping the
legacy config + updater creation; here thin aliases onto the fluid-style
optimizer classes, which ARE the in-graph updaters)."""

from .. import optimizer as fopt

__all__ = ["Momentum", "Adam", "AdaGrad", "AdaDelta", "RMSProp",
           "DecayedAdaGrad", "SGD"]


def _wrap(cls):
    def make(learning_rate=1e-3, regularization=None, model_average=None,
             gradient_clipping_threshold=None, **kw):
        kw.pop("is_async", None)
        opt = cls(learning_rate=learning_rate, **kw)
        opt._v2_regularization = regularization
        return opt
    return make


SGD = _wrap(fopt.SGDOptimizer)
Adam = _wrap(fopt.AdamOptimizer)
AdaGrad = _wrap(fopt.AdagradOptimizer)
AdaDelta = _wrap(fopt.AdadeltaOptimizer)
RMSProp = _wrap(fopt.RMSPropOptimizer)
DecayedAdaGrad = _wrap(fopt.DecayedAdagradOptimizer)


def Momentum(learning_rate=1e-3, momentum=0.9, **kw):
    kw.pop("regularization", None)
    kw.pop("model_average", None)
    return fopt.MomentumOptimizer(learning_rate=learning_rate,
                                  momentum=momentum, **kw)
