"""Book models: the RNN encoder-decoder and the beam-search translator
(the port's counterparts of the models of
``tests/book/test_rnn_encoder_decoder.py`` and
``tests/book/test_machine_translation.py``, which import the JAX
package and so cannot be loaded here), and synthetic data by the rule
of the JAX package's ``wmt14`` fallback: no dataset download.

- :func:`encoder_decoder`: a bidirectional peephole-free ``dynamic_lstm``
  encoder over the source words, its last step through an fc (tanh) the
  decoder's first state; a ``DynamicRNN`` over the target words whose
  step is an fc of [word, state] into ``gru_unit`` and a softmax fc over
  the dictionary; cross entropy against the next words, Adagrad at 0.05.
- :func:`nmt_train`: the translator's training program: an fc (tanh) and
  a ``dynamic_lstm`` over the source, its last step the context; a
  ``DynamicRNN`` decoder of fc (tanh) steps and a softmax fc; the
  source and target embeddings share ``vemb``.
- :func:`nmt_decode`: the translator's decode program: the same encoder,
  then a ``While`` over at most ``max_length`` steps whose body expands
  the state over the beam, scores the next word, keeps the ``topk`` and
  runs ``beam_search``; ``beam_search_decode`` walks the beams back.

Each builder takes the layers module ``L`` (and the optimizer module and
``ParamAttr`` where it needs them), the port's by default: the tests
build the same program through the JAX package's to compare the two.
"""
import numpy as np

from paddle_tpu_torch import layers, optimizer
from paddle_tpu_torch.param_attr import ParamAttr

START, END = 0, 1  # wmt14's <s> and <e>; 2 is <unk>

# tests/book/test_rnn_encoder_decoder.py's widths
ENCDEC = dict(dict_size=300, word_dim=16, hidden=16)
# tests/book/test_machine_translation.py's widths
NMT = dict(dict_size=500, word_dim=16, hidden=16, beam_size=2, max_length=6,
           end_id=10)


def wmt14_pairs(n, dict_size, seed=0, min_len=3, max_len=14):
    """``n`` synthetic (source, target, next target) rows, each [len, 1]
    int64, by the rule of ``paddle_tpu/dataset/wmt14.py``'s fallback:
    source words in [3, dict_size), the target the reversed source
    shifted by 7, the target after ``<s>``, the next words before
    ``<e>``. Lengths in [min_len, max_len], from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rng.randint(3, dict_size, int(rng.randint(min_len,
                                                        max_len + 1)))
        trg = [(int(w) + 7) % (dict_size - 3) + 3 for w in src[::-1]]
        out.append(tuple(np.asarray(s, np.int64).reshape(-1, 1) for s in (
            src, [START] + trg, trg + [END])))
    return out


def _ids(L, name, lod_level=1):
    return L.data(name=name, shape=[1], dtype="int64", lod_level=lod_level)


def encoder_decoder(L=layers, opt=optimizer, dict_size=ENCDEC["dict_size"],
                    word_dim=ENCDEC["word_dim"], hidden=ENCDEC["hidden"],
                    dtype="float32", lstm_impl=None, learning_rate=0.05):
    """The RNN encoder-decoder (``tests/book/test_rnn_encoder_decoder.py
    :21-62``, Adagrad at the test's 0.05 by default); ``lstm_impl`` set
    on both lstm ops. Returns its spec."""
    src = _ids(L, "source_sequence")
    src_emb = L.embedding(input=src, size=[dict_size, word_dim], dtype=dtype)
    fwd_proj = L.fc(input=src_emb, size=hidden * 4, bias_attr=False)
    fwd, _ = L.dynamic_lstm(input=fwd_proj, size=hidden * 4, dtype=dtype,
                            use_peepholes=False)
    rev_proj = L.fc(input=src_emb, size=hidden * 4, bias_attr=False)
    rev, _ = L.dynamic_lstm(input=rev_proj, size=hidden * 4, dtype=dtype,
                            is_reverse=True, use_peepholes=False)
    encoded = L.concat(input=[fwd, rev], axis=1)
    boot = L.fc(input=L.sequence_last_step(input=encoded), size=hidden,
                act="tanh")
    trg = _ids(L, "target_sequence")
    trg_emb = L.embedding(input=trg, size=[dict_size, word_dim], dtype=dtype)
    rnn = L.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        mem = rnn.memory(init=boot)
        gates = L.fc(input=[word, mem], size=hidden * 3, bias_attr=False)
        h, _, _ = L.gru_unit(input=gates, hidden=mem, size=hidden * 3)
        rnn.update_memory(mem, h)
        rnn.output(L.fc(input=h, size=dict_size, act="softmax"))
    prediction = rnn()
    label = _ids(L, "label_sequence")
    cost = L.mean(L.cross_entropy(input=prediction, label=label))
    if lstm_impl is not None:
        for op in cost.block.ops:
            if op.type == "lstm":
                op.attrs["lstm_impl"] = lstm_impl
    return {"cost": cost, "prediction": prediction,
            "feed_list": [src, trg, label],
            "optimizer": opt.Adagrad(learning_rate=learning_rate)}


def _nmt_encoder(L, PA, dict_size, word_dim, hidden):
    src = _ids(L, "src_word_id")
    emb = L.embedding(input=src, size=[dict_size, word_dim],
                      param_attr=PA(name="vemb"))
    fc1 = L.fc(input=emb, size=hidden * 4, act="tanh")
    lstm_hidden, _ = L.dynamic_lstm(input=fc1, size=hidden * 4)
    return src, L.sequence_last_step(input=lstm_hidden)


def nmt_train(L=layers, opt=optimizer, PA=ParamAttr,
              dict_size=NMT["dict_size"], word_dim=NMT["word_dim"],
              hidden=NMT["hidden"]):
    """The translator's training program (``tests/book/
    test_machine_translation.py:23-52, :95-104``). Returns its spec."""
    src, context = _nmt_encoder(L, PA, dict_size, word_dim, hidden)
    trg = _ids(L, "target_language_word")
    trg_emb = L.embedding(input=trg, size=[dict_size, word_dim],
                          param_attr=PA(name="vemb"))
    rnn = L.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        pre = rnn.memory(init=context)
        cur = L.fc(input=[word, pre], size=hidden, act="tanh")
        rnn.update_memory(pre, cur)
        rnn.output(L.fc(input=cur, size=dict_size, act="softmax"))
    prediction = rnn()
    label = _ids(L, "target_language_next_word")
    cost = L.mean(L.cross_entropy(input=prediction, label=label))
    return {"cost": cost, "prediction": prediction,
            "feed_list": [src, trg, label],
            "optimizer": opt.Adagrad(learning_rate=0.05)}


def nmt_decode(L=layers, PA=ParamAttr, dict_size=NMT["dict_size"],
               word_dim=NMT["word_dim"], hidden=NMT["hidden"],
               beam_size=NMT["beam_size"], max_length=NMT["max_length"],
               end_id=NMT["end_id"]):
    """The translator's decode program (``tests/book/
    test_machine_translation.py:55-92``): (sentence ids, sentence
    scores), fed ``src_word_id``, ``init_ids`` and ``init_scores``."""
    _, context = _nmt_encoder(L, PA, dict_size, word_dim, hidden)
    array_len = L.fill_constant(shape=[1], dtype="int64", value=max_length)
    counter = L.zeros(shape=[1], dtype="int64", force_cpu=True)
    state_array = L.create_array("float32")
    L.array_write(context, array=state_array, i=counter)
    ids_array = L.create_array("int64")
    scores_array = L.create_array("float32")
    init_ids = _ids(L, "init_ids", lod_level=2)
    init_scores = L.data(name="init_scores", shape=[1], dtype="float32",
                         lod_level=2)
    L.array_write(init_ids, array=ids_array, i=counter)
    L.array_write(init_scores, array=scores_array, i=counter)
    cond = L.less_than(x=counter, y=array_len)
    while_op = L.While(cond=cond)
    with while_op.block():
        pre_ids = L.array_read(array=ids_array, i=counter)
        pre_state = L.array_read(array=state_array, i=counter)
        pre_score = L.array_read(array=scores_array, i=counter)
        pre_state_expanded = L.sequence_expand(pre_state, pre_score)
        pre_ids_emb = L.embedding(input=pre_ids, size=[dict_size, word_dim])
        state = L.fc(input=[pre_ids_emb, pre_state_expanded], size=hidden,
                     act="tanh")
        score = L.fc(input=state, size=dict_size, act="softmax")
        topk_scores, topk_indices = L.topk(score, k=beam_size)
        selected_ids, selected_scores = L.beam_search(
            pre_ids, topk_indices, topk_scores, beam_size, end_id=end_id,
            level=0)
        L.increment(x=counter, value=1, in_place=True)
        L.array_write(state, array=state_array, i=counter)
        L.array_write(selected_ids, array=ids_array, i=counter)
        L.array_write(selected_scores, array=scores_array, i=counter)
        L.less_than(x=counter, y=array_len, cond=cond)
    return L.beam_search_decode(ids=ids_array, scores=scores_array)


def decode_feed(lod_mod, sources, start=START):
    """The decode's feed for ``sources`` (a list of [len, 1] id arrays):
    every source one prefix of the start word, score 1 (the book's
    ``init_ids`` / ``init_scores``), as ``lod_mod``'s LoDTensors."""
    n = len(sources)
    lod = [list(range(n + 1))] * 2
    return {"src_word_id": lod_mod.build_lod_tensor(list(sources)),
            "init_ids": lod_mod.LoDTensor(np.full((n, 1), start, np.int64),
                                          lod),
            "init_scores": lod_mod.LoDTensor(np.ones((n, 1), np.float32),
                                             lod)}

