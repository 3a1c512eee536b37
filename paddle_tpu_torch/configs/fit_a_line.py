"""Book config: linear regression (fit-a-line; the port's counterpart of
``examples/configs/fit_a_line.py``, which imports the JAX package and so
cannot be loaded here). The reader is synthetic: no dataset download.

Train it with the port's CLI::

    python -m paddle_tpu_torch train paddle_tpu_torch/configs/fit_a_line.py --device cpu

:func:`model` builds the JAX config's program and reader: 13 features,
one fc output, ``square_error_cost`` averaged, SGD at 0.01, 64 samples
in batches of 16 from ``RandomState(0)``.
"""
import numpy as np

from paddle_tpu_torch import layers, optimizer, reader


def model():
    x = layers.data(name="x", shape=[13], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)

    def samples():
        rng = np.random.RandomState(0)
        w = rng.rand(13, 1).astype(np.float32)
        for _ in range(64):
            xs = rng.rand(13).astype(np.float32)
            yield xs, (xs @ w).astype(np.float32)

    return {
        "cost": avg_cost,
        "feed_list": [x, y],
        "reader": reader.batch(samples, batch_size=16),
        "optimizer": optimizer.SGD(learning_rate=0.01),
        "num_passes": 1,
    }
