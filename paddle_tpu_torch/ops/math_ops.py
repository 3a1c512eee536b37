"""Math ops (counterparts in ``paddle_tpu/ops/math_ops.py``: ``mul`` :61
with ``_gemm_dispatch`` :27, ``matmul`` :103 with ``_infer_matmul`` :85,
the elementwise family :132-142, ``minus`` :145, ``sum`` :154, ``scale``
:176, ``clip`` :187, ``clip_by_norm`` :193, ``cumsum`` :201, the
reductions :217-268, ``mean`` :279, ``norm`` :285, the comparisons and
logicals :297-323, ``top_k`` :325, ``maximum`` :335, ``isfinite`` :342).

``mul`` is one gemm of the flattened operands, routed through
``paddle_tpu_torch.tune`` as the JAX op is: only a cached
per-(device, shape) winner tiling runs the hand-written blocked matmul
(``kernels/matmul.py``). No winner, a winner that says the stock rung is
fastest (``use: xla``) and every shape outside the kernel's population
run ``torch.matmul``, as the JAX package runs ``jnp.matmul``; an untuned
process computes exactly what it did before the tune slice.

Under AMP (``paddle_tpu_torch.amp``) the operands are cast to bfloat16.
An untuned bfloat16 gemm sums and writes float32
(``preferred_element_type``); a tuned one is the kernel's bfloat16 face,
which writes ``x.dtype`` (bfloat16) as the JAX kernel called with
``out_dtype=None`` does, so under plain AMP its output is rounded to
bfloat16 once before the cast back to float32, and an untuned one's is
not (``ROADMAP.md``, faults of the reference). Pure AMP keeps the
output bfloat16.

``matmul`` is ``jnp.matmul``'s product (batch dims broadcast, 1-D
operands by the vector rules) with no kernel of its own in either
package: it is :func:`acc_matmul`, a library product, whose bfloat16
operands under AMP are summed and written in float32
(``amp.matmul_f32``) before the cast to the output's dtype.
"""
from __future__ import annotations

import torch

from .. import amp, tune
from ..core.executor import (ConcreteScalar, concrete_value, raw_data,
                             with_lod_of)
from ..core.registry import register_op
from ..kernels import matmul as matmul_kernel
from .common import bcast_y_to_x, elementwise, flatten_to_2d, jax_clip

__all__ = []


def acc_matmul(a, b):
    """``jnp.matmul(a, b, preferred_element_type=_acc_type(a))``: half-
    width operands summed and written in float32, others as they are."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return amp.matmul_f32(a, b)
    return torch.matmul(a, b)


def _gemm_dispatch(x2, y2):
    """The mul op's 2-D gemm. Inside the kernel's population the tune
    cache decides (``enabled=False``: no flag opts this kernel in): a
    winner tiling runs the kernel with it, written in ``x2``'s dtype; a
    cached triple that is not one of the face's tilings is a miss and
    runs the face's default tiling; no winner (a fallback) or a ``use:
    xla`` winner (a hit) runs :func:`acc_matmul`. Outside the population
    it is :func:`acc_matmul` with a recorded fallback."""
    M, K = (int(v) for v in x2.shape)
    N = int(y2.shape[-1])
    if matmul_kernel.supports_matmul((M, K), (K, N), x2.dtype):
        cfg = tune.lookup(
            "matmul", {"m": M, "k": K, "n": N,
                       "dtype": str(x2.dtype).replace("torch.", "")},
            enabled=False,
            valid=lambda c: matmul_kernel.is_tiling(c, x2.dtype))
        if cfg is not None:
            return matmul_kernel.matmul(x2.contiguous(), y2.contiguous(),
                                        None, cfg)
    else:
        tune.record_fallback("matmul")
    return acc_matmul(x2, y2)


def _infer_mul(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    yv = block._find_var_recursive(op.input("Y")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, yv, ov) or xv.shape is None or yv.shape is None:
        return
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    ov.shape = tuple(xv.shape[:xn]) + tuple(yv.shape[yn:])
    ov.dtype = xv.dtype


@register_op("mul", infer_shape=_infer_mul)
def mul(ctx):
    """Flatten X by ``x_num_col_dims`` and Y by ``y_num_col_dims``, one
    gemm, reshape to X's leading dims + Y's trailing dims. Out keeps
    X's LoD (an fc over ragged sequences stays ragged). Under AMP the
    gemm takes bfloat16 operands; Out is written back in X's dtype, or
    kept bfloat16 under pure AMP."""
    x_v = ctx.input("X")
    x = raw_data(x_v)
    y = raw_data(ctx.input("Y"))
    out_dtype = x.dtype
    x, y = amp.cast_inputs(ctx, x, y)
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out = _gemm_dispatch(flatten_to_2d(x, xn), flatten_to_2d(y, yn))
    out = out.to(torch.bfloat16 if amp.keep_bf16(ctx, out_dtype)
                 else out_dtype)
    ctx.set_output("Out", with_lod_of(x_v, out.reshape(
        tuple(x.shape[:xn]) + tuple(y.shape[yn:]))))


def _infer_matmul(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    yv = block._find_var_recursive(op.input("Y")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, yv, ov) or xv.shape is None or yv.shape is None:
        return
    xs, ys = list(xv.shape), list(yv.shape)
    if op.attr("transpose_X", False) and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attr("transpose_Y", False) and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1 or len(ys) == 1:
        return  # the vector cases: left unset
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    ov.shape = tuple(batch) + (xs[-2], ys[-1])
    ov.dtype = xv.dtype


def swap_last(t):
    """``t`` with its last two dims swapped (a 1-D ``t`` as it is)."""
    return t.transpose(-1, -2) if t.ndim > 1 else t


@register_op("matmul", infer_shape=_infer_matmul)
def matmul(ctx):
    """X @ Y after ``transpose_X`` / ``transpose_Y``, times ``alpha``.
    Under AMP the operands are bfloat16 and the product is summed in
    float32, then cast to X's dtype (kept bfloat16 under pure AMP);
    ``alpha`` scales after the cast, as in the JAX lowering."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    out_dtype = x.dtype
    x, y = amp.cast_inputs(ctx, x, y)
    if ctx.attr("transpose_X", False):
        x = swap_last(x)
    if ctx.attr("transpose_Y", False):
        y = swap_last(y)
    out = acc_matmul(x, y).to(torch.bfloat16 if amp.keep_bf16(ctx, out_dtype)
                              else out_dtype)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output("Out", out)


def _infer_ew(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if xv is not None and ov is not None:
        ov.shape = xv.shape
        ov.dtype = xv.dtype


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    register_op(_name, infer_shape=_infer_ew)(
        lambda ctx, f=_fn: elementwise(ctx, f))


@register_op("minus", infer_shape=_infer_ew)
def minus(ctx):
    """Out = X - Y, with no axis broadcast."""
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(
        x, raw_data(x) - raw_data(ctx.input("Y"))))


@register_op("sum", infer_shape=_infer_ew)
def sum_op(ctx):
    """Multi-input add, the gradient-accumulation op of backward; Out
    keeps the first input's LoD. SelectedRows inputs
    (``paddle_tpu/ops/math_ops.py:154-170``): all sparse concatenate
    their rows, a mix is made dense."""
    from .selected_rows import SelectedRowsVal
    xs = ctx.inputs("X")
    if any(isinstance(v, SelectedRowsVal) for v in xs):
        if all(isinstance(v, SelectedRowsVal) for v in xs):
            ctx.set_output("Out", SelectedRowsVal(
                torch.cat([v.rows for v in xs]),
                torch.cat([v.values for v in xs]), xs[0].height))
            return
        xs = [v.to_dense() if isinstance(v, SelectedRowsVal) else v
              for v in xs]
    out = raw_data(xs[0])
    for v in xs[1:]:
        out = out + raw_data(v)
    ctx.set_output("Out", with_lod_of(xs[0], out))


@register_op("scale", infer_shape=_infer_ew)
def scale(ctx):
    """s * X + b (or s * (X + b)); a LoD input keeps its LoD, as the JAX
    lowering's (``paddle_tpu/ops/math_ops.py:176``)."""
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    xd = raw_data(x)
    out = xd * s + b if ctx.attr("bias_after_scale", True) else (xd + b) * s
    ctx.set_output("Out", with_lod_of(x, out))


@register_op("cumsum")
def cumsum(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if ctx.attr("reverse", False):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if ctx.attr("exclusive", False):
        out = out - x
    if ctx.attr("reverse", False):
        out = torch.flip(out, (axis,))
    ctx.set_output("Out", out)


@register_op("clip", infer_shape=_infer_ew)
def clip(ctx):
    ctx.set_output("Out", jax_clip(raw_data(ctx.input("X")),
                                   ctx.attr("min"), ctx.attr("max")))


@register_op("clip_by_norm", infer_shape=_infer_ew)
def clip_by_norm(ctx):
    """X scaled to L2 norm ``max_norm`` where its norm is larger; both
    branches computed and one selected on the device, as ``jnp.where``
    does, so no value is read back to the host."""
    x = raw_data(ctx.input("X"))
    mn = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    ctx.set_output("Out", torch.where(
        norm > mn, x * (mn / torch.clamp(norm, min=1e-12)), x))


# -- reductions (``paddle_tpu/ops/math_ops.py:217-268``) -----------------------

def _sum(x, dim, keepdim):
    # an integer sum keeps its dtype, as jnp.sum does
    dtype = x.dtype if not (x.is_floating_point() or x.is_complex()
                            or x.dtype == torch.bool) else None
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=dtype)


def _prod(x, dim, keepdim):
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "reduce_sum": _sum,
    "reduce_mean": lambda x, dim, keepdim: torch.mean(x, dim=dim,
                                                      keepdim=keepdim),
    "reduce_max": lambda x, dim, keepdim: torch.amax(x, dim=dim,
                                                     keepdim=keepdim),
    "reduce_min": lambda x, dim, keepdim: torch.amin(x, dim=dim,
                                                     keepdim=keepdim),
    "reduce_prod": _prod,
}


def _reduce(ctx, fn):
    """Reduce X over ``dim`` (a list; every dim with ``reduce_all``),
    keeping the reduced dims as 1 with ``keep_dim``. Out keeps X's LoD
    when dim 0, the batch dim, is not reduced."""
    xv = ctx.input("X")
    x = raw_data(xv)
    reduce_all = ctx.attr("reduce_all", False)
    if reduce_all:
        dim = tuple(range(x.ndim))
    else:
        dim = ctx.attr("dim", [0])
        dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    out = fn(x, dim, ctx.attr("keep_dim", False)) if dim else x
    if not reduce_all and dim and 0 not in {d % x.ndim for d in dim}:
        out = with_lod_of(xv, out)
    ctx.set_output("Out", out)


def _infer_reduce(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    if op.attr("reduce_all", False):
        ov.shape = (1,) if op.attr("keep_dim", False) else ()
        ov.dtype = xv.dtype
        return
    dim = op.attr("dim", [0])
    dims = set(dim if isinstance(dim, (list, tuple)) else [dim])
    dims = {d % len(xv.shape) for d in dims}
    if op.attr("keep_dim", False):
        shape = tuple(1 if i in dims else d
                      for i, d in enumerate(xv.shape))
    else:
        shape = tuple(d for i, d in enumerate(xv.shape) if i not in dims)
    ov.shape = shape
    ov.dtype = xv.dtype


for _name, _fn in _REDUCERS.items():
    register_op(_name, infer_shape=_infer_reduce)(
        lambda ctx, f=_fn: _reduce(ctx, f))


def _infer_mean(op, block):
    ov = block._find_var_recursive(op.output("Out")[0])
    xv = block._find_var_recursive(op.input("X")[0])
    if ov is not None:
        ov.shape = (1,)
        if xv is not None:
            ov.dtype = xv.dtype


@register_op("mean", infer_shape=_infer_mean)
def mean(ctx):
    ctx.set_output("Out", torch.mean(raw_data(ctx.input("X"))).reshape((1,)))


# -- comparisons and logicals (``paddle_tpu/ops/control_flow_ops.py:44-69``,
# whose registration wins over ``math_ops.py:297-323`` in the JAX
# package) ------------------------------------------------------------------

def _compare(ctx, fn, pyfn):
    """``fn(X, Y)`` under the ``axis`` broadcast; when both operands are
    concrete scalars (loop counters, ``max_sequence_len``) the result
    carries its host value too, which is what unrolls a While."""
    xv, yv = ctx.concrete_input("X"), ctx.concrete_input("Y")
    x, y = raw_data(xv), raw_data(yv)
    out = fn(x, bcast_y_to_x(x, y, ctx.attr("axis", -1)))
    cx, cy = concrete_value(xv), concrete_value(yv)
    if cx is not None and cy is not None:
        out = ConcreteScalar(bool(pyfn(cx, cy)), out)
    ctx.set_output("Out", out)


for _name, _fn, _py in [
    ("less_than", torch.lt, lambda a, b: a < b),
    ("less_equal", torch.le, lambda a, b: a <= b),
    ("greater_than", torch.gt, lambda a, b: a > b),
    ("greater_equal", torch.ge, lambda a, b: a >= b),
    ("equal", torch.eq, lambda a, b: a == b),
    ("not_equal", torch.ne, lambda a, b: a != b),
    ("logical_and", torch.logical_and, lambda a, b: bool(a) and bool(b)),
    ("logical_or", torch.logical_or, lambda a, b: bool(a) or bool(b)),
    ("logical_xor", torch.logical_xor, lambda a, b: bool(a) != bool(b)),
]:
    register_op(_name, no_gradient=True)(
        lambda ctx, f=_fn, p=_py: _compare(ctx, f, p))


@register_op("logical_not", no_gradient=True)
def logical_not(ctx):
    ctx.set_output("Out", torch.logical_not(raw_data(ctx.input("X"))))


@register_op("top_k", no_gradient=True)
def top_k(ctx):
    """The ``k`` largest values of the last axis and their int64
    indices, largest first."""
    vals, idx = torch.topk(raw_data(ctx.input("X")), ctx.attr("k", 1),
                           dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx)


@register_op("norm")
def norm(ctx):
    """Norm = sqrt(sum(X * X) along ``axis`` + ``epsilon``), kept as a
    dim of 1; Out = X / Norm."""
    x = raw_data(ctx.input("X"))
    n = torch.sqrt(torch.sum(x * x, dim=ctx.attr("axis", 1), keepdim=True)
                   + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Norm", n)
    ctx.set_output("Out", x / n)


@register_op("maximum")
def maximum(ctx):
    """The larger of X and Y elementwise; at a tie each gets half the
    gradient, in torch as in JAX."""
    ctx.set_output("Out", torch.maximum(raw_data(ctx.input("X")),
                                        raw_data(ctx.input("Y"))))


@register_op("isfinite", no_gradient=True)
def isfinite(ctx):
    """A 0-d bool: whether every element of every tensor of the X list
    is finite (computed on the device, nothing read back)."""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for v in ctx.inputs("X"):
        ok = torch.logical_and(ok, torch.all(torch.isfinite(raw_data(v))))
    ctx.set_output("Out", ok)
