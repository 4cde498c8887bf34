"""The reference's bf16 matmul precision, emulated on the CPU.

``jax.default_matmul_precision("bfloat16")`` rounds the operands of every
``dot_general`` and ``conv_general_dilated`` to bf16 on a TPU; XLA's CPU
ignores it. ``with_bf16_operands(fun)`` traces ``fun`` to a jaxpr and
evaluates it with the two operands of each of those primitives rounded to
bf16, in nested jaxprs too. Traced after ``jax.grad``, the jaxpr holds the
backward's transposed dots, which the TPU also runs at the same precision.
With ``only_default``, only the dots and convolutions whose precision is
``DEFAULT`` are rounded (the ones a TPU runs as one bf16 pass: those of
the ``bfloat16`` context and those that ask for it, as the flat model's
``tf32_matmul`` does), and the ``float32`` context's stay exact. A ``scan``
runs its body once per iteration. Nothing of the JAX package changes.
"""

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

ROUNDED = ("dot_general", "conv_general_dilated")
SUB_JAXPRS = ("jaxpr", "call_jaxpr", "fun_jaxpr")


def _round(x):
    return x.astype(jnp.bfloat16).astype(x.dtype) if x.dtype == jnp.float32 else x


def _one_pass(eqn, only_default: bool) -> bool:
    if eqn.primitive.name not in ROUNDED:
        return False
    if not only_default:
        return True
    prec = eqn.params.get("precision")
    return prec is not None and all(p == jax.lax.Precision.DEFAULT for p in
                                    (prec if isinstance(prec, tuple) else (prec,)))


def _scan(eqn, invals, only_default):
    p = eqn.params
    body, n_consts, n_carry = p["jaxpr"], p["num_consts"], p["num_carry"]
    consts, carry = invals[:n_consts], invals[n_consts:n_consts + n_carry]
    xs = invals[n_consts + n_carry:]
    order = range(p["length"] - 1, -1, -1) if p["reverse"] else range(p["length"])
    ys = {}
    for i in order:
        out = _eval(body.jaxpr, body.consts, *consts, *carry, *(x[i] for x in xs),
                    only_default=only_default)
        carry, ys[i] = out[:n_carry], out[n_carry:]
    n_ys = len(eqn.outvars) - n_carry
    return list(carry) + [jnp.stack([ys[i][j] for i in range(p["length"])]) for j in range(n_ys)]


def _eval(jaxpr, consts, *args, only_default: bool = False):
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
        if _one_pass(eqn, only_default):
            outs = eqn.primitive.bind(*map(_round, invals[:2]), *invals[2:], **eqn.params)
        elif eqn.primitive.name == "scan":
            outs = _scan(eqn, invals, only_default)
        elif sub is not None:
            closed = sub if hasattr(sub, "consts") else jcore.ClosedJaxpr(sub, ())
            n = len(closed.jaxpr.invars)
            outs = _eval(closed.jaxpr, closed.consts, *invals[-n:], only_default=only_default)
        else:
            subfuns, params = eqn.primitive.get_bind_params(eqn.params)
            outs = eqn.primitive.bind(*subfuns, *invals, **params)
        if not eqn.primitive.multiple_results and sub is None:
            outs = [outs]
        for v, x in zip(eqn.outvars, outs):
            env[v] = x
    return [read(v) for v in jaxpr.outvars]


def with_bf16_operands(fun, only_default: bool = False):
    """``fun`` with every dot's and conv's operands rounded to bf16 (with
    ``only_default``, those of ``DEFAULT`` precision)."""
    def wrapped(*args):
        closed, shape = jax.make_jaxpr(fun, return_shape=True)(*args)
        flat = jax.tree_util.tree_leaves(args)
        outs = _eval(closed.jaxpr, closed.consts, *flat, only_default=only_default)
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shape), outs)

    return wrapped
