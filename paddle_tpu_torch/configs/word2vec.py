"""Book config: the word2vec N-gram model (the port's counterpart of
``examples/configs/word2vec.py``, which imports the JAX package and so
cannot be loaded here). The reader is synthetic: no dataset download.

Train it with the port's CLI::

    python -m paddle_tpu_torch train paddle_tpu_torch/configs/word2vec.py --device cpu

:func:`model` builds the JAX config's program and reader by default:
four context words, each looked up in one shared table ``shared_w``
[200, 16], the four embeddings concatenated, an fc of 64 with sigmoid,
an fc over the vocabulary with softmax, cross entropy against the next
word, SGD at 0.001; the 5-grams of 512 ids from ``RandomState(0)`` in
batches of 32. Its keywords set other widths (the Paddle book's are a
dictionary of 2074 words, embeddings of 32 and a hidden fc of 256); the
batch, the learning rate and the reader's seed are the JAX config's.
"""
import numpy as np

from paddle_tpu_torch import layers, optimizer, reader
from paddle_tpu_torch.param_attr import ParamAttr

VOCAB = 200
EMB = 16


def model(vocab=VOCAB, emb=EMB, hidden=64):
    words = [layers.data(name="w%d" % i, shape=[1], dtype="int64")
             for i in range(4)]
    next_word = layers.data(name="next_word", shape=[1], dtype="int64")
    embs = [layers.embedding(
        w, size=[vocab, emb], dtype="float32",
        param_attr=ParamAttr(name="shared_w")) for w in words]
    concat = layers.concat(input=embs, axis=1)
    hid = layers.fc(input=concat, size=hidden, act="sigmoid")
    predict = layers.fc(input=hid, size=vocab, act="softmax")
    cost = layers.cross_entropy(input=predict, label=next_word)
    avg_cost = layers.mean(cost)

    def samples():
        rng = np.random.RandomState(0)
        seq = rng.randint(0, vocab, 512).astype(np.int64)
        for i in range(len(seq) - 5):
            yield tuple(seq[i + j].reshape(1) for j in range(5))

    return {
        "cost": avg_cost,
        "prediction": predict,
        "feed_list": words + [next_word],
        "reader": reader.batch(samples, batch_size=32),
        "optimizer": optimizer.SGD(learning_rate=0.001),
        "num_passes": 1,
    }
