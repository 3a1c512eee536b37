"""Book config: a CIFAR-shaped ResNet-20 classifier on synthetic images
(the port's counterpart of ``examples/configs/resnet_cifar.py``, which
imports the JAX package and so cannot be loaded here).

Train it with the port's CLI::

    python -m paddle_tpu_torch train \
        paddle_tpu_torch/configs/resnet_cifar.py --device cpu

:func:`model` builds the same program and reader as the JAX config:
images of 3 x 32 x 32 drawn with ``RandomState(0).rand``, labels with
``randint``, 32 samples in batches of 8, ``Momentum(0.01, 0.9)``, cross
entropy over the softmax and a top-1 accuracy. Its keyword arguments
take other networks and sizes (``chip_smoke.py`` builds ImageNet
ResNet-50 at 224 x 224 through it), defaulting to the JAX config's.

The config opts the convs of its own program into the hand-written
conv3x3 kernel: each conv2d op carries ``conv_impl="pallas3x3"`` as an
attr, so no other program of the process is touched
(``PADDLE_TPU_CONV_IMPL`` still overrides it). ``FLAGS.conv_impl``
stays ``"conv"``, as in the JAX package, whose convs reach the kernel
only when ``bench.py``'s autotuner pins it or a tune winner is cached.
A winner in the port's tune cache (``python -m paddle_tpu_torch tune``)
outranks the attr for its shape: ``{}`` runs the kernel and ``use: xla``
runs ``F.conv2d``, whatever the attr says.
"""
import numpy as np

from paddle_tpu_torch import amp as amp_mod
from paddle_tpu_torch import layers, optimizer, reader
from paddle_tpu_torch import models


def model(variant="cifar", depth=20, image=32, class_dim=10, batch=8,
          samples=32, learning_rate=0.01, conv_impl="pallas3x3", amp=False):
    """The train config dict of the CLI's contract: ``cost``,
    ``metrics``, ``feed_list``, ``reader`` (batched), ``optimizer``,
    ``num_passes``. Every conv2d op of the program carries
    ``conv_impl`` ('pallas3x3' or 'conv') as its attr. ``amp``: False,
    True (AMP: bfloat16 operands in the convs and the fc) or "pure"
    (bfloat16 activations too), as ``bench.py:_build_program``
    enables it."""
    img = layers.data(name="img", shape=[3, image, image], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    pred = models.resnet(img, class_dim=class_dim, depth=depth,
                         variant=variant)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=pred, label=label)
    for op in avg_cost.block.ops:
        if op.type == "conv2d":
            op.attrs["conv_impl"] = conv_impl
    if amp:
        amp_mod.enable(avg_cost.block.program, pure=(amp == "pure"))

    def samples_reader():
        rng = np.random.RandomState(0)
        for _ in range(samples):
            yield (rng.rand(3, image, image).astype(np.float32),
                   rng.randint(0, class_dim, (1,)).astype(np.int64))

    return {
        "cost": avg_cost,
        "metrics": [acc],
        "feed_list": [img, label],
        "reader": reader.batch(samples_reader, batch_size=batch),
        "optimizer": optimizer.Momentum(learning_rate=learning_rate,
                                        momentum=0.9),
        "num_passes": 1,
    }
