"""Model families of the port (counterpart of ``paddle_tpu/models``,
exported as its ``__init__`` exports them). Every builder appends ops to the current default
program and returns its output variables."""
from .lenet import lenet5  # noqa: F401
from .mlp import mlp  # noqa: F401
from .vgg import vgg16, vgg_cifar  # noqa: F401
from .resnet import resnet, resnet_cifar10, resnet_imagenet  # noqa: F401
from .alexnet import alexnet  # noqa: F401
from .ctr import deepfm, synthetic_click_batch, wide_deep  # noqa: F401
from .googlenet import googlenet  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig, TransformerLM, transformer_lm, transformer_block,
)
