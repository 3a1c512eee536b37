"""The layers DSL (counterpart of ``paddle_tpu/layers``): the layers the
transformer LM, ResNet, the stacked-RNN text classifier, their losses,
the optimization surface (clipping, regularization, learning-rate
schedules), the dense tensor and loss ops, the rest of the conv-net
path, the sequence stack (RNN units, the sequence ops, CRF, CTC,
NCE, ``hsigmoid``) and control flow (While, StaticRNN, DynamicRNN,
IfElse, Switch, the tensor arrays, beam search) call. Importing it
registers the op lowerings, whose shape inference runs as the ops are
appended. Variables get their operator sugar (``math_op_patch.py``)
here."""
from .. import ops as _registered_ops  # noqa: F401
from . import (control_flow, io, math_op_patch, nn, sequence,  # noqa: F401
               tensor)
from . import ops as _ops_mod
from .control_flow import *  # noqa: F401,F403
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
