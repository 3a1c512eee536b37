"""Program-to-program autodiff (counterpart of
``paddle_tpu/core/backward.py``).

``append_backward`` walks the ops that reach the loss in reverse and
appends their grad ops: an op's explicit grad maker where it has one
(``ops/explicit_grads.py``), else the generic grad op that replays the
forward lowering under ``torch.autograd`` (``ops/generic_grad.py``). A
gradient that a second consumer contributes is renamed
(``X@GRAD@RENAME_n``) and merged by a ``sum`` op into ``X@GRAD@ACC_n``;
a parameter whose final gradient is such an accumulator gets an
``assign`` to its canonical ``P@GRAD``. The program structure is the
JAX package's, name for name. A gradient var takes the ``lod_level``
of its forward var; at run time a LoD var's gradient is a ``LoDValue``
with the forward value's offsets, and an output of an op whose
gradient nobody produced gets no cotangent in the generic grad (zero,
as in the JAX package), LoD or not.

Not ported yet: the post-pass ``_check_backward_pass``, which needs the
``analysis`` package.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from . import ir, registry, unique_name
from .ir import grad_var_name
from .types import is_floating

__all__ = ["append_backward", "default_grad_maker"]


def _op_path_to_loss(block: ir.Block, loss_name: str) -> List[int]:
    """Indices of ops that (transitively) contribute to the loss."""
    needed = {loss_name}
    path = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if set(op.output_arg_names) & needed:
            path.append(i)
            needed |= set(op.input_arg_names)
    return list(reversed(path))


def default_grad_maker(op: ir.Operator, block: ir.Block,
                       grad_of: Dict[str, str], no_grad: Set[str]):
    """The generic grad op desc of a forward op: its inputs are every
    forward input slot, every forward output slot and ``<out>@GRAD``
    slots bound to the outputs' gradients; its outputs are
    ``<in>@GRAD`` for the floating, not suppressed inputs."""
    inputs = {s: list(ns) for s, ns in op.inputs.items()}
    out_slots = list(op.outputs)
    in_slots = list(op.inputs)
    diff_slots = {}
    any_outgrad = False
    for s in out_slots:
        inputs[s] = list(op.outputs[s])
        gnames = []
        for n in op.outputs[s]:
            g = grad_of.get(n)
            gnames.append(g if g is not None else "")
            if g is not None:
                any_outgrad = True
        inputs[s + "@GRAD"] = gnames
    if not any_outgrad:
        return None
    outputs = {}
    for s in in_slots:
        gout, want = [], []
        for n in op.inputs[s]:
            var = block._find_var_recursive(n)
            ok = (n not in no_grad and var is not None
                  and not var.stop_gradient
                  and (var.dtype is None or is_floating(var.dtype)))
            want.append(ok)
            gout.append(grad_var_name(n) if ok else "")
        if any(want):
            outputs[s + "@GRAD"] = gout
            diff_slots[s] = want
    if not outputs:
        return None
    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = op.type
    attrs["__fwd_input_slots__"] = in_slots
    attrs["__fwd_output_slots__"] = out_slots
    attrs["__diff_slots__"] = diff_slots
    return [("generic_grad", inputs, outputs, attrs)]


def _make_grad_vars(block: ir.Block, op_descs):
    for (_, _, outputs, _) in op_descs:
        for names in outputs.values():
            for n in names:
                if n and not block.has_var(n):
                    fwd = n[:-len(ir.GRAD_SUFFIX)] \
                        if n.endswith(ir.GRAD_SUFFIX) else None
                    fv = block._find_var_recursive(fwd) if fwd else None
                    block.create_var(
                        name=n,
                        shape=fv.shape if fv is not None else None,
                        dtype=fv.dtype if fv is not None else "float32",
                        lod_level=fv.lod_level if fv is not None else 0)


def append_backward(loss: ir.Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None) -> List[Tuple[ir.Parameter, ir.Variable]]:
    """Append the grad ops of ``loss``'s program; returns
    (parameter, gradient var) pairs for the optimizer."""
    block = loss.block
    program = block.program
    no_grad: Set[str] = set(no_grad_set or ())
    for v in program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)

    loss_grad = grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape or (1,),
                     dtype=loss.dtype)
    block.append_op(
        type="fill_constant", outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or (1,)), "value": 1.0,
               "dtype": str(loss.dtype), "force_cpu": False})

    path = _op_path_to_loss(block, loss.name)
    grad_of: Dict[str, str] = {loss.name: loss_grad}

    for i in reversed(path):
        op = block.ops[i]
        opdef = registry.lookup(op.type)
        if opdef is not None and opdef.no_gradient:
            continue
        maker = (opdef.grad_maker if opdef is not None and opdef.grad_maker
                 else default_grad_maker)
        descs = maker(op, block, grad_of, no_grad)
        if not descs:
            continue
        final_descs = []
        for (gtype, gin, gout, gattrs) in descs:
            sums = []
            for names in gout.values():
                for j, n in enumerate(names):
                    if not n:
                        continue
                    fwd_name = n[:-len(ir.GRAD_SUFFIX)]
                    if grad_of.get(fwd_name) is not None:
                        # another consumer already contributed: rename
                        # this one and sum the two
                        renamed = unique_name.generate(n + "@RENAME")
                        names[j] = renamed
                        fv = block._find_var_recursive(fwd_name)
                        like = dict(shape=fv.shape if fv else None,
                                    dtype=fv.dtype if fv else "float32",
                                    lod_level=fv.lod_level if fv else 0)
                        block.create_var(name=renamed, **like)
                        acc = unique_name.generate(n + "@ACC")
                        block.create_var(name=acc, **like)
                        sums.append(("sum",
                                     {"X": [grad_of[fwd_name], renamed]},
                                     {"Out": [acc]}, {}))
                        grad_of[fwd_name] = acc
                    else:
                        grad_of[fwd_name] = n
            final_descs.append((gtype, gin, gout, gattrs))
            final_descs.extend(sums)  # the grad op runs before its sums
        _make_grad_vars(block, final_descs)
        for (gtype, gin, gout, gattrs) in final_descs:
            block.append_op(type=gtype, inputs=gin, outputs=gout,
                            attrs=gattrs)

    params = (parameter_list if parameter_list is not None
              else [p.name for p in program.all_parameters()
                    if getattr(p, "trainable", True)])
    params_and_grads = []
    for pname in params:
        p = block._find_var_recursive(pname)
        g = grad_of.get(pname)
        if g is None or pname in no_grad:
            continue
        if g != grad_var_name(pname):
            canon = grad_var_name(pname)
            if not block.has_var(canon):
                block.create_var(name=canon, shape=p.shape, dtype=p.dtype)
            block.append_op(type="assign", inputs={"X": [g]},
                            outputs={"Out": [canon]})
            g = canon
        params_and_grads.append((p, block.var(g)))
    return params_and_grads
