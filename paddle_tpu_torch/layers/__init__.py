"""The layers DSL (counterpart of ``paddle_tpu/layers``): the layers the
transformer LM, ResNet, the stacked-RNN text classifier, their losses,
the optimization surface (clipping, regularization, learning-rate
schedules), the dense tensor and loss ops, the rest of the conv-net
path and the sequence stack (RNN units, the sequence ops, CRF, CTC,
NCE, ``hsigmoid``) call. Importing it
registers the op lowerings, whose shape inference runs as the ops are
appended. Variables get their operator sugar (``math_op_patch.py``)
here."""
from .. import ops as _registered_ops  # noqa: F401
from . import io, math_op_patch, nn, sequence, tensor  # noqa: F401
from . import ops as _ops_mod
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

# the generated unary layers fill any name not written by hand above, as
# in paddle_tpu/layers/__init__.py
for _n in _ops_mod.__all__:
    if _n not in globals():
        globals()[_n] = getattr(_ops_mod, _n)
del _n
