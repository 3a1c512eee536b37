"""Book config: the stacked-RNN text classifier of
``benchmark/rnn_bench.py`` (an IMDB-style sentiment net, after the
reference harness ``benchmark/paddle/rnn/rnn.py``) on synthetic ragged
word sequences.

Train it with the port's CLI::

    python -m paddle_tpu_torch train \\
        paddle_tpu_torch/configs/text_rnn.py --device cpu

:func:`model` builds rnn_bench's net: an embedding of the words, then
``layers`` times an fc to the gate width and a ``dynamic_lstm`` (every
second one reversed), ``sequence_pool(max)``, an fc softmax over two
classes, cross entropy and Adam. Two changes, both so that the net
reaches the fused recurrence kernels: the LSTMs run without peepholes
(rnn_bench leaves ``use_peepholes=True``, whose 7-wide bias the fused
gate refuses), and every lstm (or gru) op carries ``lstm_impl`` as its
attr, so only this program opts in (``FLAGS.lstm_impl`` stays
``"scan"``). With ``cell="gru"`` each layer is an fc to ``3 * hidden``
and a ``dynamic_gru`` instead, the encoder of ``benchmark/nmt_bench.py``.
``bias=False`` builds each LSTM layer's projection and recurrence
without biases, the net that reaches the fused LSTM kernel's bfloat16
face under pure AMP (``amp.enable(program, pure=True)``, the caller's
choice): the projection's output stays bfloat16 and no float32 bias
widens it. The GRU has no such form, as ``dynamic_gru`` always makes its
bias.

The reader draws each batch as rnn_bench draws its one: ``batch`` word
sequences of ``seq_len`` ids with ``RandomState(0).randint(0, vocab)``,
then ``batch`` binary labels. The defaults are small, for the CPU;
``chip_smoke.py`` trains rnn_bench's widths (vocab 30000, hidden 512,
100 words, batch 64) through the keyword arguments.
"""
import numpy as np

from paddle_tpu_torch import layers as L
from paddle_tpu_torch import optimizer, reader


def model(cell="lstm", vocab=1000, hidden=128, layers=2, seq_len=16,
          batch=8, samples=32, learning_rate=0.002, lstm_impl="pallas",
          bias=True):
    """The train config dict of the CLI's contract: ``cost``,
    ``metrics``, ``feed_list``, ``reader`` (batched), ``optimizer``,
    ``num_passes``. ``cell`` is 'lstm' or 'gru'; ``lstm_impl`` ('pallas'
    or 'scan') rides on every recurrent op of the program; ``bias=False``
    (LSTM only) drops the biases of each layer's fc and dynamic_lstm."""
    if cell not in ("lstm", "gru"):
        raise ValueError("cell must be 'lstm' or 'gru', got %r" % (cell,))
    if not bias and cell == "gru":
        raise ValueError("bias=False is for cell='lstm': dynamic_gru "
                         "always makes its bias")
    bias_attr = None if bias else False
    words = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    inp = L.embedding(input=words, size=[vocab, hidden])
    for i in range(layers):
        if cell == "lstm":
            proj = L.fc(input=inp, size=hidden * 4, bias_attr=bias_attr)
            inp, _ = L.dynamic_lstm(input=proj, size=hidden * 4,
                                    use_peepholes=False,
                                    bias_attr=bias_attr,
                                    is_reverse=(i % 2 == 1))
        else:
            proj = L.fc(input=inp, size=hidden * 3)
            inp = L.dynamic_gru(input=proj, size=hidden,
                                is_reverse=(i % 2 == 1))
    pooled = L.sequence_pool(input=inp, pool_type="max")
    pred = L.fc(input=pooled, size=2, act="softmax")
    avg_cost = L.mean(L.cross_entropy(input=pred, label=label))
    for op in avg_cost.block.ops:
        if op.type in ("lstm", "gru"):
            op.attrs["lstm_impl"] = lstm_impl

    def samples_reader():
        rng = np.random.RandomState(0)
        for start in range(0, samples, batch):
            n = min(batch, samples - start)
            seqs = [rng.randint(0, vocab, (seq_len, 1)).astype("int64")
                    for _ in range(n)]
            labels = rng.randint(0, 2, (n, 1)).astype("int64")
            for s, lab in zip(seqs, labels):
                yield s, lab

    return {
        "cost": avg_cost,
        "metrics": [],
        "feed_list": [words, label],
        "reader": reader.batch(samples_reader, batch_size=batch),
        "optimizer": optimizer.Adam(learning_rate=learning_rate),
        "num_passes": 1,
    }
