"""Importing this package registers every op lowering of the port
(counterpart of ``paddle_tpu/ops/__init__.py``). The ported slices hold
the ops of the transformer LM's, ResNet's, the stacked-RNN text
classifier's and fit_a_line's training steps, and the host IO ops."""
from . import (  # noqa: F401
    common,
    generic_grad,
    tensor_ops,
    math_ops,
    nn_ops,
    loss_ops,
    metric_ops,
    optimizer_ops,
    attention_ops,
    sequence_ops,
    io_ops,
    explicit_grads,  # last: attaches grad makers to the ops above
)

from ..core.registry import registered_ops  # noqa: F401
