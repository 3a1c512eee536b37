"""Devices: where the port computes (the counterpart of ``paddle_tpu/place.py``).

Every entry point of the port takes an explicit ``device`` argument that
defaults to ``"cuda"``. :func:`resolve_device` turns it into a
``torch.device`` and raises when a CUDA device is asked for and the
process has none: the port never falls back to the CPU on its own. The
CPU runs only when a caller asks for it (the CPU tests pass
``device="cpu"``), and there every kernel wrapper takes its plain
PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "NoDeviceError", "resolve_device"]

DEFAULT_DEVICE = "cuda"


class NoDeviceError(RuntimeError):
    """A CUDA device was asked for and this process has none."""


def resolve_device(device=DEFAULT_DEVICE):
    """``device`` (a string, index-qualified string or ``torch.device``)
    -> ``torch.device``; raises :class:`NoDeviceError` for ``cuda`` when
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for any
    type other than ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "device %r asked for, but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU" % (str(device),))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError("the port runs on 'cuda' or 'cpu', got %r"
                         % (str(device),))
    return dev
