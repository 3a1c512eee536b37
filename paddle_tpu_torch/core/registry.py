"""Op registry: op type -> (torch lowering, shape inference, grad maker)
(counterpart of ``paddle_tpu/core/registry.py``).

A lowering is a function of a ``LowerContext`` that reads its inputs
as tensors and sets its outputs. An op either registers an explicit
grad maker (``ops/explicit_grads.py``) or gets the default one, whose
``generic_grad`` op replays the forward lowering under
``torch.autograd`` (``ops/generic_grad.py``). An op marked ``host``
(a bool, or a predicate ``fn(op)``) must run on the host, outside a
captured step: ``save`` / ``load`` and ``print``; the Executor runs a
program holding one on its hybrid path.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["OpDef", "lookup", "lookup_checked", "op_is_host",
           "register_op", "registered_ops", "set_infer_shape"]

_REGISTRY: Dict[str, "OpDef"] = {}


class OpDef(object):
    __slots__ = ("type", "lower", "infer_shape", "grad_maker", "host",
                 "stateful_outputs", "no_gradient")

    def __init__(self, type, lower=None, infer_shape=None, grad_maker=None,
                 host=False, stateful_outputs=(), no_gradient=False):
        self.type = type
        self.lower = lower
        self.infer_shape = infer_shape
        # fn(op, block, grad_of, no_grad) -> [(type, inputs, outputs, attrs)]
        self.grad_maker = grad_maker
        # runs on the host (save / load / print): a bool, or a predicate
        # fn(op) -> bool for ops that are host-bound under some attrs
        self.host = host
        self.stateful_outputs = tuple(stateful_outputs)
        self.no_gradient = no_gradient


def register_op(type, infer_shape=None, grad_maker=None, host=False,
                stateful_outputs=(), no_gradient=False):
    """Decorator registering ``fn`` as the torch lowering of op ``type``."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, lower=fn, infer_shape=infer_shape,
                                grad_maker=grad_maker, host=host,
                                stateful_outputs=stateful_outputs,
                                no_gradient=no_gradient)
        return fn

    return deco


def op_is_host(opdef, op) -> bool:
    """Whether ``op`` (of ``opdef``) must run on the host."""
    h = opdef.host
    return bool(h(op)) if callable(h) else bool(h)


def set_infer_shape(type, fn):
    lookup_checked(type).infer_shape = fn


def lookup(type) -> Optional[OpDef]:
    return _REGISTRY.get(type)


def lookup_checked(type) -> OpDef:
    opdef = _REGISTRY.get(type)
    if opdef is None:
        raise NotImplementedError(
            "Op %r has no registered lowering in paddle_tpu_torch. "
            "Registered: %s" % (type, registered_ops()))
    return opdef


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)
