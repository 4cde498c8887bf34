"""The reference's bf16 matmul precision, emulated on the CPU.

``jax.default_matmul_precision("bfloat16")`` rounds the operands of every
``dot_general`` and ``conv_general_dilated`` to bf16 on a TPU; XLA's CPU
ignores it. ``with_bf16_operands(fun)`` traces ``fun`` to a jaxpr and
evaluates it with the two operands of each of those primitives rounded to
bf16, in nested jaxprs too. Traced after ``jax.grad``, the jaxpr holds the
backward's transposed dots, which the TPU also runs at the same precision.
Nothing of the JAX package changes.
"""

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

ROUNDED = ("dot_general", "conv_general_dilated")
SUB_JAXPRS = ("jaxpr", "call_jaxpr", "fun_jaxpr")


def _round(x):
    return x.astype(jnp.bfloat16).astype(x.dtype) if x.dtype == jnp.float32 else x


def _eval(jaxpr, consts, *args):
    env = {}

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    for v, x in zip(jaxpr.constvars, consts):
        env[v] = x
    for v, x in zip(jaxpr.invars, args):
        env[v] = x
    for eqn in jaxpr.eqns:
        invals = [read(v) for v in eqn.invars]
        sub = next((eqn.params[k] for k in SUB_JAXPRS if k in eqn.params), None)
        if eqn.primitive.name in ROUNDED:
            outs = eqn.primitive.bind(*map(_round, invals[:2]), *invals[2:], **eqn.params)
        elif sub is not None:
            closed = sub if hasattr(sub, "consts") else jcore.ClosedJaxpr(sub, ())
            n = len(closed.jaxpr.invars)
            outs = _eval(closed.jaxpr, closed.consts, *invals[-n:])
        else:
            subfuns, params = eqn.primitive.get_bind_params(eqn.params)
            outs = eqn.primitive.bind(*subfuns, *invals, **params)
        if not eqn.primitive.multiple_results and sub is None:
            outs = [outs]
        for v, x in zip(eqn.outvars, outs):
            env[v] = x
    return [read(v) for v in jaxpr.outvars]


def with_bf16_operands(fun):
    """``fun`` with every dot's and conv's operands rounded to bf16."""
    def wrapped(*args):
        closed, shape = jax.make_jaxpr(fun, return_shape=True)(*args)
        flat = jax.tree_util.tree_leaves(args)
        outs = _eval(closed.jaxpr, closed.consts, *flat)
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shape), outs)

    return wrapped
