"""bf16 matmul precision: every conv and linear reads bf16-rounded operands.

The reference's ``matmul_precision="bfloat16"`` is
``jax.default_matmul_precision("bfloat16")``: each dot and convolution
(``dot_general``, ``conv_general_dilated``) rounds its two operands to
bfloat16 and accumulates in float32, and the dots that autodiff derives
from it (the transposes in a backward pass, and the transposes of those in
the gradient penalty's second-order terms) inherit the same precision. The
outputs, bias adds, activations and reductions stay float32.

``bf16_operands()`` does the same for the port: inside it every
``conv1d``, ``linear`` and ``matmul`` on float32 operands runs as one of
the three bilinear maps of ``<dot(a, b), g>`` (the product, and its
derivatives with respect to ``a`` and ``b``), each on bf16-rounded operands
in float32 arithmetic. A product of two bf16 values is exact in float32, so
only the accumulation rounds, as on the TPU's one-pass bf16. Each map's
derivatives are the other two maps, so every order of differentiation reads
rounded operands. The biases are added in float32 after the product.

TF32 must be off where exactness matters: with TF32 on, a bf16 value is
still exact in TF32, so the products stay exact either way.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode

_aten = torch.ops.aten


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16, in its own float32 dtype."""
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


def _conv_args(meta):
    stride, padding, dilation, groups = meta
    return list(stride), list(padding), list(dilation), groups


def _compute(kind: str, slot: str, a: torch.Tensor, b: torch.Tensor, meta, shape):
    """One of the three bilinear maps of ``kind`` on rounded ``a``, ``b``.

    ``slot`` names the output: ``y`` the product of (x, w); ``x`` its
    derivative with respect to x, from (g, w); ``w`` its derivative with
    respect to w, from (x, g). ``shape`` is the output's shape for ``x``
    and ``w``."""
    a, b = round_bf16(a), round_bf16(b)
    if kind == "conv":
        stride, padding, dilation, groups = _conv_args(meta)
        if slot == "y":
            return _aten.convolution(a, b, None, stride, padding, dilation, False, [0], groups)
        if slot == "x":   # a = g, b = w
            x = a.new_empty(1).expand(shape)
            return _aten.convolution_backward(a, x, b, None, stride, padding, dilation, False,
                                              [0], groups, [True, False, False])[0]
        w = a.new_empty(1).expand(shape)   # a = x, b = g
        return _aten.convolution_backward(b, a, w, None, stride, padding, dilation, False,
                                          [0], groups, [False, True, False])[1]
    # kind == "mm": y = x @ w over the last two axes, batched over the leading
    if slot == "y":
        return torch.matmul(a, b)
    if slot == "x":   # a = g, b = w: g @ wᵀ, summed to x's shape
        return _sum_to(torch.matmul(a, b.transpose(-1, -2)), shape)
    return _sum_to(torch.matmul(a.transpose(-1, -2), b), shape)   # a = x, b = g


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the broadcast axes of a matmul operand of ``shape``."""
    return t if t.shape == shape else t.sum_to_size(shape)


class _Bilinear(torch.autograd.Function):
    """``_compute`` with its derivatives, which are ``_Bilinear`` maps too."""

    @staticmethod
    def forward(ctx, kind, slot, a, b, meta, shapes):
        ctx.kind, ctx.slot, ctx.meta, ctx.shapes = kind, slot, meta, shapes
        ctx.save_for_backward(a, b)
        return _compute(kind, slot, a, b, meta, shapes[slot])

    @staticmethod
    def backward(ctx, h):
        a, b = ctx.saved_tensors
        kind, meta, shapes = ctx.kind, ctx.meta, ctx.shapes
        op = lambda slot, p, q: _Bilinear.apply(kind, slot, p, q, meta, shapes)  # noqa: E731
        need_a, need_b = ctx.needs_input_grad[2:4]
        if ctx.slot == "y":     # (x, w) -> y
            da = op("x", h, b) if need_a else None
            db = op("w", a, h) if need_b else None
        elif ctx.slot == "x":   # (g, w) -> x; h is x-shaped
            da = op("y", h, b) if need_a else None
            db = op("w", h, a) if need_b else None
        else:                   # (x, g) -> w; h is w-shaped
            da = op("x", b, h) if need_a else None
            db = op("y", a, h) if need_b else None
        return None, None, da, db, None, None


def _tuple(v) -> tuple:
    return tuple(v) if isinstance(v, Sequence) else (v,)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv1d`` on bf16-rounded operands (integer padding only)."""
    if isinstance(padding, str):
        raise NotImplementedError("bf16 operands: conv1d with string padding")
    meta = (_tuple(stride), _tuple(padding), _tuple(dilation), groups)
    y = _Bilinear.apply("conv", "y", x, weight, meta,
                        {"y": None, "x": x.shape, "w": weight.shape})
    return y if bias is None else y + bias[:, None]


def matmul(a, b):
    """``a @ b`` on bf16-rounded operands."""
    return _Bilinear.apply("mm", "y", a, b, None, {"y": None, "x": a.shape, "w": b.shape})


def linear(x, weight, bias=None):
    """``F.linear`` on bf16-rounded operands."""
    y = matmul(x, weight.t())
    return y if bias is None else y + bias


_HANDLERS = {   # F.conv1d is torch.conv1d, F.linear torch._C._nn.linear
    torch.conv1d: conv1d,
    torch.nn.functional.linear: linear,
    torch.matmul: matmul,
    torch.Tensor.matmul: matmul,
    torch.Tensor.__matmul__: matmul,
}


class _Bf16Operands(TorchFunctionMode):
    """Routes the float32 convs and matmuls of its block through ``_HANDLERS``
    while ``active``."""

    def __init__(self):
        super().__init__()
        self.active = True

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func) if self.active else None
        if handler is not None and all(
                t.dtype == torch.float32 for t in args[:2] if isinstance(t, torch.Tensor)):
            return handler(*args, **kwargs)
        return func(*args, **kwargs)


_current: Optional[_Bf16Operands] = None


@contextlib.contextmanager
def bf16_operands(enabled: bool = True):
    """Every float32 conv1d, linear and matmul in the block reads
    bf16-rounded operands (the reference's bf16 matmul precision)."""
    global _current
    if not enabled:
        yield
        return
    outer, mode = _current, _Bf16Operands()
    _current = mode
    try:
        with mode:
            yield
    finally:
        _current = outer


@contextlib.contextmanager
def full_operands():
    """Inside a ``bf16_operands`` block: float32 operands again for this
    block (the gradient penalty of the mixed modes). The ops traced here
    keep float32 in their derivatives too."""
    mode = _current
    if mode is None:
        yield
        return
    was, mode.active = mode.active, False
    try:
        yield
    finally:
        mode.active = was


def rounding() -> bool:
    """Whether the float32 convs and matmuls of this point read rounded operands."""
    return _current is not None and _current.active


def operands(rounded: bool):
    """A context in which they read rounded operands, or float32 ones: a
    recomputation in the backward (``torch.utils.checkpoint``) sees no
    function mode of its own, so it enters the forward's state again."""
    return bf16_operands() if rounded else full_operands()
