"""Book config: a transformer LM on synthetic next-token data (the
port's counterpart of ``examples/configs/tiny_lm.py``, which imports the
JAX package and so cannot be loaded here).

Train it with the port's CLI::

    python -m paddle_tpu_torch train paddle_tpu_torch/configs/tiny_lm.py --device cpu

:func:`model` builds the same program and reader as the JAX config; its
keyword arguments take other widths (``chip_smoke.py`` trains GPT-2
small's through it), defaulting to tiny_lm's own. Each sample is a row
of ``seq`` token ids drawn with numpy from ``seed`` and its target, each
id plus one modulo the vocabulary.
"""
import numpy as np

from paddle_tpu_torch import layers, optimizer, reader
from paddle_tpu_torch.models import transformer

VOCAB = 32
SEQ = 32
BATCH = 16
HIDDEN = 32
LAYERS = 2
HEADS = 4
SAMPLES = 24


def lm_config(vocab=VOCAB, seq=SEQ, hidden=HIDDEN, num_layers=LAYERS,
              num_heads=HEADS, ffn_mult=4):
    """The serving TransformerConfig matching :func:`model` with the same
    widths."""
    return transformer.TransformerConfig(
        vocab_size=vocab, hidden=hidden, num_layers=num_layers,
        num_heads=num_heads, ffn_mult=ffn_mult, max_seq=seq)


def model(vocab=VOCAB, seq=SEQ, batch=BATCH, hidden=HIDDEN,
          num_layers=LAYERS, num_heads=HEADS, ffn_mult=4, samples=SAMPLES,
          learning_rate=0.01, seed=0):
    """The train config dict of the CLI's contract: ``cost``,
    ``feed_list``, ``reader`` (batched), ``optimizer``, ``num_passes``."""
    toks = layers.data("toks", shape=[seq], dtype="int64")
    toks.shape = (-1, seq)
    tgt = layers.data("tgt", shape=[seq], dtype="int64")
    tgt.shape = (-1, seq)
    logits = transformer.transformer_lm(
        toks, vocab_size=vocab, hidden=hidden, num_layers=num_layers,
        num_heads=num_heads, ffn_mult=ffn_mult)
    flat = layers.reshape(logits, shape=[-1, vocab])
    cost = layers.mean(layers.softmax_with_cross_entropy(
        flat, layers.reshape(tgt, shape=[-1, 1])))

    def samples_reader():
        rng = np.random.RandomState(seed)
        for _ in range(samples):
            xs = rng.randint(0, vocab, (seq,)).astype(np.int64)
            yield xs, (xs + 1) % vocab

    return {
        "cost": cost,
        "feed_list": [toks, tgt],
        "reader": reader.batch(samples_reader, batch_size=batch),
        "optimizer": optimizer.Adam(learning_rate=learning_rate),
        "num_passes": 1,
    }
