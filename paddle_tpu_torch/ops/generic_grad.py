"""The generic gradient op: replays a forward lowering under
``torch.autograd`` (counterpart of ``paddle_tpu/ops/generic_grad.py:35``,
which replays it under ``jax.vjp``).

The op holds the forward op's inputs and outputs, the incoming
``<out>@GRAD`` cotangents, and ``__diff_slots__`` naming the inputs that
want a gradient. It runs the forward lowering again on detached copies
of those inputs with autograd on, then takes ``torch.autograd.grad`` of
the replayed outputs against the cotangents. An output whose gradient
var is unnamed gets no cotangent (a zero one in the JAX package), and an
input the outputs do not depend on gets zeros. A LoD-valued input
(``LoDValue``) differentiates through its data tensor, which is the
primal; its offsets ride along as constants, and its gradient carries
the input's LoD, as ``paddle_tpu/ops/generic_grad.py:49`` has it. A
differentiable input that is neither raises instead of coming out as
zeros. A forward op whose
lowering calls a kernel wrapper that is a ``torch.autograd.Function``
(flash attention) reaches that wrapper's backward kernels here.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.executor import FunctionalContext, raw_data, with_lod_of

__all__ = []


def _generic_grad_is_host(op):
    """A generic grad replays its forward lowering, so it runs on the
    host exactly when the forward op does (the forward's attrs are on the
    grad op, so a predicate evaluates unchanged;
    ``paddle_tpu/ops/generic_grad.py:22``)."""
    fwd = registry.lookup(op.attr("__fwd_type__"))
    return fwd is not None and registry.op_is_host(fwd, op)


@registry.register_op("generic_grad", host=_generic_grad_is_host)
def generic_grad(ctx):
    fwd_type = ctx.attr("__fwd_type__")
    in_slots = list(ctx.attr("__fwd_input_slots__"))
    out_slots = list(ctx.attr("__fwd_output_slots__"))
    diff_slots = ctx.attr("__diff_slots__")  # slot -> [bool per name]
    fwd_def = registry.lookup_checked(fwd_type)
    fwd_attrs = {k: v for k, v in ctx.op.attrs.items()
                 if not k.startswith("__")}

    in_vals = {s: list(ctx.inputs(s)) for s in in_slots}
    prim_index, primals = [], []
    for s in in_slots:
        flags = diff_slots.get(s, [False] * len(in_vals[s]))
        for i, v in enumerate(in_vals[s]):
            if not (i < len(flags) and flags[i]) or v is None:
                continue
            data = raw_data(v)
            if not isinstance(data, torch.Tensor):
                raise TypeError(
                    "generic grad of %r: input %s[%d] wants a gradient but "
                    "holds %s, not a tensor or a LoD value"
                    % (fwd_type, s, i, type(v).__name__))
            if not data.is_floating_point():
                continue
            p = data.detach().requires_grad_(True)
            in_vals[s][i] = with_lod_of(v, p)
            prim_index.append((s, i, v))
            primals.append(p)

    fwd_outputs = {s: list(ctx.op.input(s)) for s in out_slots}
    fctx = FunctionalContext(ctx.op, in_vals, fwd_attrs, ctx.device,
                             outputs=fwd_outputs, type=fwd_type)
    with torch.enable_grad():
        fwd_def.lower(fctx)

    outs, cots = [], []
    for s in out_slots:
        replayed = fctx.collected.get(s, [])
        for i, gn in enumerate(ctx.op.input(s + "@GRAD")):
            o = raw_data(replayed[i]) if i < len(replayed) else None
            if not gn or o is None or not o.requires_grad:
                continue
            g = raw_data(ctx.env[gn])
            outs.append(o)
            cots.append(g.to(o.dtype).reshape(o.shape))
    if outs:
        grads = torch.autograd.grad(outs, primals, grad_outputs=cots,
                                    allow_unused=True)
    else:
        grads = [None] * len(primals)

    for (s, i, v), p, g in zip(prim_index, primals, grads):
        names = ctx.op.output(s + "@GRAD")
        if i < len(names) and names[i]:
            ctx.env[names[i]] = with_lod_of(
                v, torch.zeros_like(p) if g is None else g)
