"""The layers DSL (counterpart of ``paddle_tpu/layers``): the layers the
transformer LM, ResNet, the stacked-RNN text classifier and their losses
call. Importing it registers the op lowerings, whose shape inference
runs as the ops are appended."""
from .. import ops as _registered_ops  # noqa: F401
from . import io, nn, ops, sequence, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
