"""Kernel search spaces: what is tunable, what is valid, what is stock
(counterpart of ``paddle_tpu/tune/space.py``).

A :class:`KernelSpace` declares, for one of the port's CUDA kernels:

- ``params``: the tunable axes and their values, which here are the
  tilings the kernel's source is compiled for;
- ``is_valid``: the hard constraints on a config at a shape key, and
  ``smem_bytes``: the shared memory one thread block of it takes, which
  must fit :data:`SMEM_BUDGET` (the JAX spaces model VMEM instead);
- ``build``: config -> callable running the kernel in that config;
- ``reference``: the stock rung, the plain PyTorch library call the port
  makes outside any kernel (``torch.matmul``, ``F.conv2d``) with TF32
  off, as the JAX package's stock rung is XLA's lowering;
- ``make_operands``: deterministic inputs for a shape key, drawn with
  ``numpy.random.RandomState(seed)`` exactly as the JAX spaces draw
  them, so that both packages race the same numbers.

A *key* is a plain dict describing one shape/dtype population instance
(``{"m": 8192, "k": 768, "n": 768, "dtype": "float32"}``);
``signature(key)`` renders it canonically for the winner cache. Two
spaces ship: matmul and conv3x3. The flash-attention and
paged-attention spaces of the JAX package are not ported.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE

__all__ = ["Conv3x3Space", "KernelSpace", "MatmulSpace", "SMEM_BUDGET",
           "get_space", "signature", "space_names"]

# shared memory one thread block of an H100 can use (dynamic, after
# cudaFuncSetAttribute): 227 KB of the SM's 256 KB
SMEM_BUDGET = 227 * 1024


def signature(key):
    """Canonical cache-signature string for a shape key dict."""
    return ",".join("%s=%s" % (k, key[k]) for k in sorted(key))


@contextlib.contextmanager
def no_tf32():
    """Full float32 products for cuBLAS and cuDNN inside the block (the
    stock rung's precision, which the kernels match)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _tensor(a, dtype, device):
    from ..core.types import torch_dtype
    return torch.as_tensor(np.ascontiguousarray(a)).to(
        device=device, dtype=torch_dtype(dtype))


class KernelSpace(object):
    """Base: declares the contract; subclasses fill the kernel-specific
    parts. ``candidates`` is shared: the cartesian product of ``params``
    filtered by ``is_valid`` and the shared-memory budget, default config
    first, deduplicated."""

    name = None
    params = {}

    def default_config(self, key):
        raise NotImplementedError

    def is_valid(self, config, key):
        raise NotImplementedError

    def smem_bytes(self, config, key):
        raise NotImplementedError

    def build(self, config, key):
        """config -> callable(*operands) running the kernel variant."""
        raise NotImplementedError

    def reference(self, key):
        """callable(*operands) running the stock PyTorch lowering."""
        raise NotImplementedError

    def make_operands(self, key, seed=0, device=DEFAULT_DEVICE):
        raise NotImplementedError

    def candidates(self, key, budget=None):
        """Valid configs for ``key``: the default first, then the pruned
        cartesian product of ``params``. ``budget`` caps the list length
        (the default survives any positive cap; 0 means no kernel
        candidate at all; None is uncapped)."""
        out, seen = [], set()
        for cfg in [self.default_config(key)] + self._enumerate():
            frozen = tuple(sorted(cfg.items()))
            if frozen in seen:
                continue
            seen.add(frozen)
            if self.is_valid(cfg, key) \
                    and self.smem_bytes(cfg, key) <= SMEM_BUDGET:
                out.append(dict(cfg))
        if budget is not None:
            out = out[:max(int(budget), 0)]
        return out

    def _enumerate(self):
        names = sorted(self.params)
        return [dict(zip(names, vals)) for vals in
                itertools.product(*(self.params[n] for n in names))]


class MatmulSpace(KernelSpace):
    """Tiling space of ``kernels/matmul.py`` (2-D gemm). key: {m, k, n,
    dtype}. The values are exactly the template instantiations of
    ``csrc/matmul.cu``; the kernel masks its ragged edges, so every
    tiling is right at every shape. A block wider than its extent is
    pruned as idle threads, unless it is the narrowest value or the
    default tiling (which stays valid everywhere, as the JAX default's
    full extent does)."""

    name = "matmul"
    params = {
        "block_m": (64, 128),
        "block_n": (64, 128),
        "block_k": (8, 16, 32),
    }

    def default_config(self, key):
        from ..kernels.matmul import DEFAULT_CONFIG
        return dict(DEFAULT_CONFIG)

    def is_valid(self, config, key):
        from ..kernels.matmul import TILINGS, normalize_config
        try:
            bm, bn, bk = (int(config[k])
                          for k in ("block_m", "block_n", "block_k"))
        except (KeyError, TypeError, ValueError):
            return False
        if (bm, bn, bk) not in TILINGS:
            return False
        if (bm, bn, bk) == normalize_config():
            return True
        lo = {name: min(vals) for name, vals in self.params.items()}
        return ((bm == lo["block_m"] or bm <= key["m"])
                and (bn == lo["block_n"] or bn <= key["n"])
                and (bk == lo["block_k"] or bk <= key["k"]))

    def smem_bytes(self, config, key):
        from ..kernels.matmul import smem_bytes
        return smem_bytes(int(config["block_m"]), int(config["block_n"]),
                          int(config["block_k"]))

    def make_operands(self, key, seed=0, device=DEFAULT_DEVICE):
        rng = np.random.RandomState(seed)
        x = rng.randn(key["m"], key["k"])
        w = rng.randn(key["k"], key["n"]) * 0.1
        return (_tensor(x, key["dtype"], device),
                _tensor(w, key["dtype"], device))

    def build(self, config, key):
        from ..kernels.matmul import matmul
        cfg = dict(config)

        def fn(x, w):
            return matmul(x, w, None, cfg)

        return fn

    def reference(self, key):
        def fn(x, w):
            with no_tf32():
                return torch.matmul(x, w)

        return fn


class Conv3x3Space(KernelSpace):
    """Space of ``kernels/conv3x3.py`` (3x3 / s1 / p1, NHWC x HWIO).
    key: {n, h, w, c, o, dtype}. The kernel has one fixed tiling (64
    pixels x 64 channels a block, 16 input channels a step), so the one
    candidate is ``{}``; the JAX space's block_n / block_o / grid_order
    are a TPU schedule that means nothing to it."""

    name = "conv3x3"
    params = {}

    # csrc/conv3x3.cu: as[16][68] + bs[16][64] floats
    SMEM = (16 * 68 + 16 * 64) * 4

    def default_config(self, key):
        return {}

    def is_valid(self, config, key):
        return not config

    def smem_bytes(self, config, key):
        return self.SMEM

    def make_operands(self, key, seed=0, device=DEFAULT_DEVICE):
        rng = np.random.RandomState(seed)
        x = rng.randn(key["n"], key["h"], key["w"], key["c"])
        w = rng.randn(3, 3, key["c"], key["o"]) * 0.1
        return (_tensor(x, key["dtype"], device),
                _tensor(w, key["dtype"], device))

    def build(self, config, key):
        from ..kernels.conv3x3 import conv3x3_s1_nhwc

        def fn(x, w):
            return conv3x3_s1_nhwc(x, w)

        return fn

    def reference(self, key):
        import torch.nn.functional as F

        def fn(x, w):
            with no_tf32():
                out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                               None, 1, 1)
            return out.permute(0, 2, 3, 1)

        return fn


_SPACES = {sp.name: sp for sp in (Conv3x3Space(), MatmulSpace())}


def get_space(name):
    if name not in _SPACES:
        raise KeyError("unknown kernel space %r (have: %s)"
                       % (name, ", ".join(sorted(_SPACES))))
    return _SPACES[name]


def space_names():
    return sorted(_SPACES)
