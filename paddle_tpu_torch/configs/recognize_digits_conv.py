"""Book config: the MNIST-shaped conv classifier (recognize-digits; the
port's counterpart of ``examples/configs/recognize_digits_conv.py``,
which imports the JAX package and so cannot be loaded here), with a
synthetic digit reader.

Train it with the port's CLI::

    python -m paddle_tpu_torch train \\
        paddle_tpu_torch/configs/recognize_digits_conv.py --device cpu

:func:`model` builds the JAX config's program and reader: LeNet-5
(``models/lenet.py``) on 1 x 28 x 28 images, cross entropy and a top-1
accuracy, Adam at 0.001, 64 samples in batches of 16 drawn with
``RandomState(0)``.
"""
import numpy as np

from paddle_tpu_torch import layers, optimizer, reader
from paddle_tpu_torch.models import lenet


def model():
    img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    pred, avg_cost, acc = lenet.lenet5(img, label)

    def samples():
        rng = np.random.RandomState(0)
        for _ in range(64):
            yield (rng.rand(1, 28, 28).astype(np.float32),
                   rng.randint(0, 10, (1,)).astype(np.int64))

    return {
        "cost": avg_cost,
        "metrics": [acc],
        "feed_list": [img, label],
        "reader": reader.batch(samples, batch_size=16),
        "optimizer": optimizer.Adam(learning_rate=0.001),
        "num_passes": 1,
    }
