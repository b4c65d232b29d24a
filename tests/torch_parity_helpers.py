"""Op-by-op parity helpers shared by the port's sequence tests: run a
JAX-package lowering and the port's lowering of the same op type on the
same seeded numpy inputs, forward and gradients.

Tolerances (tests/test_torch_nn_ops.py's): 1e-5 absolute on float32
forward values, and on gradients 1e-4 of the largest |reference|
element of each gradient (both packages sum the same terms in
different orders). Integer outputs are compared exactly.

This module imports JAX: the card-only tests use
tests/torch_port_helpers.py instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as jpt  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.ops import registry as preg

FWD_ATOL = 1e-5
GRAD_REL = 1e-4


class _JCtx:
    is_test = False
    mesh = None
    amp_dtype = None

    def next_key(self):
        return jax.random.PRNGKey(0)


class _PCtx:
    is_test = False
    amp_dtype = None
    generator = None
    op = None
    in_place = False
    device = torch.device("cpu")


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def run_both(op, ins, attrs=None, out="Out", grad=(), seed=0, cot=None):
    """Forward of both lowerings on the same inputs; gradients of output
    slot `out` (or of every slot of a tuple `out` at once) with respect
    to the float input slots in `grad`, under seeded cotangents (or
    `cot`, for one slot). Returns (jax outputs, torch outputs, jax
    grads, torch grads)."""
    attrs = dict(attrs or {})
    ins = {k: [_f32(v) for v in vs] for k, vs in ins.items()}
    jctx, pctx = _JCtx(), _PCtx()
    jfn = jreg.get_op(op).lowering
    pfn = preg.get_op(op).lowering
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    jout = jfn(jctx, jins, dict(attrs))
    pins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    with torch.no_grad():
        pout = pfn(pctx, pins, dict(attrs))
    if not grad:
        return jout, pout, None, None

    slots = out if isinstance(out, tuple) else (out,)

    def jf(*vals):
        d = dict(jins)
        for s, v in zip(grad, vals):
            d[s] = [v]
        res = jfn(jctx, d, dict(attrs))
        return tuple(res[o][0] for o in slots)

    ys, vjp = jax.vjp(jf, *[jins[s][0] for s in grad])
    rng = np.random.RandomState(seed + 1)
    cots = [np.asarray(cot) if cot is not None
            else rng.randn(*y.shape).astype(np.float32) for y in ys]
    jg = vjp(tuple(jnp.asarray(c, y.dtype) for c, y in zip(cots, ys)))
    leaves = {s: pins[s][0].clone().requires_grad_(True) for s in grad}
    d = dict(pins)
    for s in grad:
        d[s] = [leaves[s]]
    res = pfn(pctx, d, dict(attrs))
    pys = [res[o][0] for o in slots]
    pg = torch.autograd.grad(pys, [leaves[s] for s in grad],
                             [torch.from_numpy(c).to(y.dtype)
                              for c, y in zip(cots, pys)],
                             allow_unused=True)
    pg = [torch.zeros_like(leaves[s]) if g is None else g
          for s, g in zip(grad, pg)]
    return jout, pout, jg, pg


def check_outputs(jout, pout, atol=FWD_ATOL, skip=()):
    """Every output slot of the reference: same shape, floats within
    `atol`, integers and bools equal."""
    for slot, jvals in jout.items():
        if slot in skip:
            continue
        assert slot in pout, slot
        for jv, pv in zip(jvals, pout[slot]):
            jv = np.asarray(jv)
            pv = pv.detach().numpy()
            assert pv.shape == jv.shape, (slot, pv.shape, jv.shape)
            if jv.dtype.kind == "f":
                np.testing.assert_allclose(pv, jv, rtol=0, atol=atol,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(pv, jv, err_msg=slot)


def check_grads(jg, pg, rel=GRAD_REL):
    for j, p in zip(jg, pg):
        j = np.asarray(j)
        p = p.numpy()
        assert p.shape == j.shape
        tol = rel * max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(p, j, rtol=0, atol=tol)


def lengths(seed, B, T, zero=True):
    """Ragged int32 lengths in [1, T], the first row T and, with `zero`,
    the last row 0."""
    lens = np.random.RandomState(seed).randint(1, T + 1, (B,)).astype(
        np.int32)
    lens[0] = T
    if zero:
        lens[-1] = 0
    return lens


def uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)
