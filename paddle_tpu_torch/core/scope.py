"""Scope: the runtime name -> value store (counterpart of
``paddle_tpu/core/scope.py``). Values are ``torch.Tensor``s on the
Executor's device, plus the Executor's ``torch.Generator`` under
``@RNG_KEY@``.

:func:`scope_from_numpy` and :func:`scope_to_numpy` carry state across
packages: the JAX scope's persistables as ``{name: np.ndarray}``
(parameters, Adam moments, ``beta*_pow_acc``, the learning rate) become
tensors of this scope on a device, and come back out again.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["Scope", "global_scope", "scope_from_numpy", "scope_guard",
           "scope_to_numpy"]


class Scope(object):
    def __init__(self, parent: "Scope" = None):
        self.parent = parent
        self._vars: Dict[str, Any] = {}
        # bumped when the set of names changes (not on a value update):
        # the Executor keys its memo of a program's state inputs on it
        self._names_version = 0

    def find_var(self, name: str):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value):
        """Write through to the scope that owns the name, else local."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value
        self._names_version += 1

    def erase(self, name: str):
        if name in self._vars:
            self._names_version += 1
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def __contains__(self, name):
        return self.has_var(name)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def scope_from_numpy(state, device="cuda", scope=None):
    """Install ``state`` ({name: array}) as tensors on ``device`` in
    ``scope`` (default a new Scope) and return the scope. Arrays keep
    their dtype; every array is copied."""
    from ..device import resolve_device
    dev = resolve_device(device)
    scope = Scope() if scope is None else scope
    for name, value in state.items():
        scope.set_var(name, torch.tensor(np.asarray(value), device=dev))
    return scope


def scope_to_numpy(scope, names=None):
    """{name: np.ndarray} of the tensors in ``scope`` (its own and its
    parents'), or of ``names`` only, copied out. Non-tensor entries (the
    Executor's generator) are left out."""
    if names is None:
        names, s = set(), scope
        while s is not None:
            names.update(s.local_var_names())
            s = s.parent
    out = {}
    for n in sorted(names):
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            # a copy: the Executor's compiled path updates state tensors
            # in place, and a CPU tensor's numpy() shares its memory
            out[n] = v.detach().cpu().numpy().copy()
    return out
