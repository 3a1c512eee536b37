"""Shared by the checkpoint and program tests of the port: the port's book
configs and their JAX twins, built alike under each package's
``unique_name.guard()`` (so that every variable has the same name in
both), the same numpy feeds for both, and training runs of each package
from one state (the JAX startup's, carried into the port's scope: the
two initializers draw from different generators).

Kinds: ``fit_a_line``, ``tiny_lm`` and ``recognize_digits_conv`` (the
JAX configs of ``examples/configs`` beside the port's), ``resnet_cifar``
(a ResNet-8 at 16 x 16, batch 4, its convs on the plain path in both),
``text_rnn`` (the LSTM classifier at small widths on ragged words,
the recurrence on its scan path in both), ``word2vec`` (the port's
``configs/word2vec.py`` at the widths of ``tests/book/test_word2vec.py``
over the dictionary of the JAX package's synthetic ``imikolov`` corpus,
its 5-grams the feeds, its SGD at 0.01 set here; the JAX twin is
``examples/configs/word2vec.py``'s program at those widths) and
``recommender`` (the model of
``tests/book/test_recommender_system.py:16-63`` built alike in both,
the JAX package's synthetic ``movielens`` rows the feeds: titles and
categories ragged, pooled by ``sequence_pool(sum)``, a ``cos_sim``
head), ``image_classification_vgg`` (the ``vgg_small`` of
``tests/book/test_image_classification.py:12-23``: two
``nets.img_conv_group`` blocks with batch norm, fc, batch norm, fc, a
softmax classifier; Momentum at 0.01, 0.9, as ``resnet_cifar``: in
float32 the book's Adam would move each bias ahead of a batch norm,
whose gradient is zero but for float32 noise, by +-lr at random in each
package; built in float64, ``dtype="float64"``, the kind trains alike
under both, ``book_adam=True`` taking the book's Adam) and
``recognize_digits_nets`` (the
conv net of ``tests/book/test_recognize_digits.py:18-26``: two
``nets.simple_img_conv_pool``, a softmax classifier, Adam at 0.003),
both fed seeded synthetic images of the datasets' shapes (CIFAR-10's
3 x 32 x 32, MNIST's 784) made here, ``understand_sentiment_conv`` and
``understand_sentiment_lstm`` (``convolution_net`` and
``stacked_lstm_net`` of ``tests/book/test_understand_sentiment.py:17-51``
at its widths, embeddings and hidden 16, over imdb's 5147 words; Adam
at 0.002), fed seeded synthetic reviews of 8 to 40 words, and
``label_semantic_roles`` (``db_lstm`` of
``tests/book/test_label_semantic_roles.py:28-95`` at its widths, depth 4,
hidden 32, with ``linear_chain_crf`` on the shared ``crfw`` transition
and ``crf_decoding`` the prediction; SGD at 0.01), fed seeded synthetic
sentences of 4 to 20 words over the dictionary sizes of the JAX
package's synthetic ``conll05`` (4000 words, 300 predicates, 30
labels), the 9 ragged slots of a CoNLL-05 row. The book kinds train in
batches of 16. The control flow kinds (``CF_KINDS``, kept out of
``KINDS``): ``rnn_encoder_decoder`` and ``machine_translation``, the
training programs of ``tests/book/test_rnn_encoder_decoder.py`` and
``tests/book/test_machine_translation.py`` at their widths
(``paddle_tpu_torch/models/machine_translation.py`` builds both
packages' programs), fed the first batches of the JAX package's
synthetic ``wmt14`` in the book's batches of 2.
"""
import contextlib
import importlib.util
import inspect
import os
import textwrap

import numpy as np

import paddle_tpu as jpt
from paddle_tpu import layers as jlayers
from paddle_tpu import models as jmodels
from paddle_tpu import nets as jnets
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import unique_name as jun
from paddle_tpu.dataset import imikolov as jimikolov
from paddle_tpu.dataset import movielens as jmovielens
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.configs import fit_a_line as tfit
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.configs import recognize_digits_conv as tdigits
from paddle_tpu_torch.configs import resnet_cifar as tresnet
from paddle_tpu_torch.configs import text_rnn as trnn
from paddle_tpu_torch.configs import tiny_lm as ttiny
from paddle_tpu_torch.configs import word2vec as tw2v
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import scope_from_numpy, scope_to_numpy
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("fit_a_line", "tiny_lm", "resnet_cifar", "text_rnn",
         "recognize_digits_conv", "word2vec", "recommender",
         "image_classification_vgg", "recognize_digits_nets",
         "understand_sentiment_conv", "understand_sentiment_lstm",
         "label_semantic_roles")
IMAGE_KINDS = ("image_classification_vgg", "recognize_digits_nets")
CF_KINDS = ("rnn_encoder_decoder", "machine_translation")
CF_FEEDS = {"rnn_encoder_decoder": ("source_sequence", "target_sequence",
                                    "label_sequence"),
            "machine_translation": ("src_word_id", "target_language_word",
                                    "target_language_next_word")}
CF_BATCH = 2  # the book tests' batch
# persistables of a control flow kind after its steps: within 1e-4 of
# max(1, the largest magnitude). Adagrad divides each element's step by
# the root of that element's own squared gradients, so an embedding row
# whose gradient is mostly float32 cancellation moves by as much as its
# relative error allows: the step-1 gradients of both packages agree
# with a float64 run to 5.4e-7 (relative norm) and the losses to 1e-7,
# while ``vemb`` differs by 5.2e-5 after 3 steps
CF_STATE_TOL = 1e-4
# losses within 1e-5 relative, persistables within 1e-5 of max(1, the
# largest magnitude): float32 on both sides, sums in other orders
REL_TOL = 1e-5
RNN = dict(vocab=200, hidden=32, layers=2, batch=4, learning_rate=0.002)
RESNET = dict(variant="cifar", depth=8, image=16, class_dim=10, batch=4)
# tests/book/test_word2vec.py's widths over imikolov's dictionary
W2V = dict(vocab=len(jimikolov.build_dict()), emb=16, hidden=64,
           learning_rate=0.01)
BOOK_BATCH = 16
BOOK_BATCHES = 4
# tests/book/test_recommender_system.py's id ranges, from the corpus
REC = dict(users=jmovielens.max_user_id() + 1,
           movies=jmovielens.max_movie_id() + 1,
           jobs=jmovielens.max_job_id() + 1,
           ages=len(jmovielens.age_table), categories=18, titles=512,
           learning_rate=0.2)
REC_FEEDS = ("user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "title_ids", "score")
# tests/book/test_understand_sentiment.py's widths, imdb's vocabulary
SENT = dict(vocab=5147, emb=16, hid=16, stacked=3, learning_rate=0.002,
            min_len=8, max_len=40)
SENT_KINDS = ("understand_sentiment_conv", "understand_sentiment_lstm")
# tests/book/test_label_semantic_roles.py's widths; the dictionary sizes
# of the JAX package's synthetic conll05 (paddle_tpu/dataset/conll05.py)
SRL = dict(words=4000, preds=300, labels=30, marks=2, word_dim=16,
           mark_dim=4, hidden=32, depth=4, mix_hidden_lr=1.0,
           learning_rate=0.01, min_len=4, max_len=20)
SRL_FEEDS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
             "target")


def jax_config(name):
    spec = importlib.util.spec_from_file_location(
        "jax_book_" + name, os.path.join(ROOT, "examples", "configs",
                                         name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rnn():
    words = jlayers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    inp = jlayers.embedding(input=words, size=[RNN["vocab"], RNN["hidden"]])
    for i in range(RNN["layers"]):
        proj = jlayers.fc(input=inp, size=RNN["hidden"] * 4)
        inp, _ = jlayers.dynamic_lstm(input=proj, size=RNN["hidden"] * 4,
                                      use_peepholes=False,
                                      is_reverse=(i % 2 == 1))
    pooled = jlayers.sequence_pool(input=inp, pool_type="max")
    pred = jlayers.fc(input=pooled, size=2, act="softmax")
    cost = jlayers.mean(jlayers.cross_entropy(input=pred, label=label))
    return {"cost": cost, "feed_list": [words, label], "prediction": pred,
            "optimizer": jpt.optimizer.Adam(
                learning_rate=RNN["learning_rate"])}


def _jax_resnet():
    img = jlayers.data(name="img", shape=[3, RESNET["image"],
                                          RESNET["image"]], dtype="float32")
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    pred = jmodels.resnet(img, class_dim=RESNET["class_dim"],
                          depth=RESNET["depth"], variant=RESNET["variant"])
    cost = jlayers.mean(x=jlayers.cross_entropy(input=pred, label=label))
    acc = jlayers.accuracy(input=pred, label=label)
    return {"cost": cost, "metrics": [acc], "feed_list": [img, label],
            "prediction": pred,
            "optimizer": jpt.optimizer.Momentum(learning_rate=0.01,
                                                momentum=0.9)}


def _jax_w2v():
    """``examples/configs/word2vec.py``'s program at ``W2V``'s widths."""
    words = [jlayers.data(name="w%d" % i, shape=[1], dtype="int64")
             for i in range(4)]
    next_word = jlayers.data(name="next_word", shape=[1], dtype="int64")
    embs = [jlayers.embedding(
        w, size=[W2V["vocab"], W2V["emb"]], dtype="float32",
        param_attr=jpt.ParamAttr(name="shared_w")) for w in words]
    concat = jlayers.concat(input=embs, axis=1)
    hidden = jlayers.fc(input=concat, size=W2V["hidden"], act="sigmoid")
    predict = jlayers.fc(input=hidden, size=W2V["vocab"], act="softmax")
    cost = jlayers.mean(jlayers.cross_entropy(input=predict,
                                              label=next_word))
    return {"cost": cost, "feed_list": words + [next_word],
            "prediction": predict,
            "optimizer": jpt.optimizer.SGD(
                learning_rate=W2V["learning_rate"])}


def _w2v_samples():
    """The first BOOK_BATCHES batches of imikolov's training 5-grams."""
    out = []
    for gram in jimikolov.train(jimikolov.build_dict(), 5)():
        out.append(tuple(np.array([w], np.int64) for w in gram))
        if len(out) == BOOK_BATCHES * BOOK_BATCH:
            return out
    return out


def recommender(L, optimizer):
    """``tests/book/test_recommender_system.py:16-63`` through the layers
    module ``L`` of either package, its ids in ``REC``'s ranges."""
    def ids(name, lod_level=0):
        return L.data(name=name, shape=[1], dtype="int64",
                      lod_level=lod_level)

    uid = ids("user_id")
    usr_fc = L.fc(input=L.embedding(input=uid, size=[REC["users"], 16]),
                  size=16)
    gender = ids("gender_id")
    g_fc = L.fc(input=L.embedding(input=gender, size=[2, 8]), size=8)
    age = ids("age_id")
    a_fc = L.fc(input=L.embedding(input=age, size=[REC["ages"], 8]), size=8)
    job = ids("job_id")
    j_fc = L.fc(input=L.embedding(input=job, size=[REC["jobs"], 8]), size=8)
    usr = L.fc(input=L.concat(input=[usr_fc, g_fc, a_fc, j_fc], axis=1),
               size=32, act="tanh")
    mov_id = ids("movie_id")
    mov_fc = L.fc(input=L.embedding(input=mov_id, size=[REC["movies"], 16]),
                  size=16)
    category = ids("category_id", lod_level=1)
    mov_cat = L.sequence_pool(
        input=L.embedding(input=category, size=[REC["categories"], 16]),
        pool_type="sum")
    title = ids("title_ids", lod_level=1)
    title_pool = L.sequence_pool(
        input=L.embedding(input=title, size=[REC["titles"], 16]),
        pool_type="sum")
    mov = L.fc(input=L.concat(input=[mov_fc, mov_cat, title_pool], axis=1),
               size=32, act="tanh")
    scale_infer = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
    label = L.data(name="score", shape=[1], dtype="float32")
    cost = L.mean(L.square_error_cost(input=scale_infer, label=label))
    return {"cost": cost,
            "feed_list": [uid, gender, age, job, mov_id, category, title,
                          label],
            "prediction": scale_infer,
            "optimizer": optimizer.SGD(learning_rate=REC["learning_rate"])}


def _rec_samples():
    """The first BOOK_BATCHES batches of movielens' training rows."""
    rows = list(jmovielens.train()())[:BOOK_BATCHES * BOOK_BATCH]
    return [tuple(r[:7]) + (np.asarray(r[7], np.float32).reshape(1),)
            for r in rows]


def image_classification_vgg(L, nets, optimizer, dtype="float32",
                             book_adam=False):
    """``vgg_small`` (``tests/book/test_image_classification.py:12-23``)
    and the test's head, through the layers module ``L`` and the nets
    module ``nets`` of either package. ``dtype``: the image's, which
    every parameter takes; ``book_adam``: the book's Adam at 0.002
    (``:64``) instead of Momentum."""
    def conv_block(ipt, num_filter, groups):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True, pool_type="max")

    images = L.data(name="pixel", shape=[3, 32, 32], dtype=dtype)
    label = L.data(name="label", shape=[1], dtype="int64")
    conv2 = conv_block(conv_block(images, 8, 2), 16, 2)
    bn = L.batch_norm(input=L.fc(input=conv2, size=32, act=None),
                      act="relu")
    feat = L.fc(input=bn, size=32, act=None)
    predict = L.fc(input=feat, size=10, act="softmax")
    cost = L.mean(L.cross_entropy(input=predict, label=label))
    acc = L.accuracy(input=predict, label=label)
    opt = optimizer.Adam(learning_rate=0.002) if book_adam else \
        optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    return {"cost": cost, "metrics": [acc], "feed_list": [images, label],
            "prediction": predict, "optimizer": opt}


def recognize_digits_nets(L, nets, optimizer):
    """The conv net of ``tests/book/test_recognize_digits.py:18-26`` and
    the test's head."""
    img = L.data(name="img", shape=[784], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    img2d = L.reshape(img, [-1, 1, 28, 28])
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img2d, filter_size=5, num_filters=8, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=16, pool_size=2,
        pool_stride=2, act="relu")
    predict = L.fc(input=conv_pool_2, size=10, act="softmax")
    cost = L.mean(L.cross_entropy(input=predict, label=label))
    acc = L.accuracy(input=predict, label=label)
    return {"cost": cost, "metrics": [acc], "feed_list": [img, label],
            "prediction": predict,
            "optimizer": optimizer.Adam(learning_rate=0.003)}


def understand_sentiment(L, nets, optimizer, net, w=SENT):
    """``convolution_net`` (``net="conv"``) or ``stacked_lstm_net``
    (``"lstm"``) of ``tests/book/test_understand_sentiment.py:17-51``
    and the test's head, at the widths ``w``; ``w["use_peepholes"]``
    (default the book's True) goes to every LSTM."""
    data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    emb = L.embedding(input=data, size=[w["vocab"], w["emb"]])
    if net == "conv":
        conv_3 = nets.sequence_conv_pool(input=emb, num_filters=w["hid"],
                                         filter_size=3, act="tanh",
                                         pool_type="sqrt")
        conv_4 = nets.sequence_conv_pool(input=emb, num_filters=w["hid"],
                                         filter_size=4, act="tanh",
                                         pool_type="sqrt")
        prediction = L.fc(input=[conv_3, conv_4], size=2, act="softmax")
    else:
        peep = w.get("use_peepholes", True)
        fc1 = L.fc(input=emb, size=w["hid"])
        lstm1, _ = L.dynamic_lstm(input=fc1, size=w["hid"],
                                  use_peepholes=peep)
        inputs = [fc1, lstm1]
        for i in range(2, w["stacked"] + 1):
            fc = L.fc(input=inputs, size=w["hid"])
            lstm, _ = L.dynamic_lstm(input=fc, size=w["hid"],
                                     is_reverse=(i % 2) == 0,
                                     use_peepholes=peep)
            inputs = [fc, lstm]
        fc_last = L.sequence_pool(input=inputs[0], pool_type="max")
        lstm_last = L.sequence_pool(input=inputs[1], pool_type="max")
        prediction = L.fc(input=[fc_last, lstm_last], size=2, act="softmax")
    cost = L.mean(L.cross_entropy(input=prediction, label=label))
    acc = L.accuracy(input=prediction, label=label)
    return {"cost": cost, "metrics": [acc], "feed_list": [data, label],
            "prediction": prediction,
            "optimizer": optimizer.Adam(learning_rate=w["learning_rate"])}


def label_semantic_roles(L, optimizer, ParamAttr, w=SRL):
    """``db_lstm`` of ``tests/book/test_label_semantic_roles.py:28-95``
    with the test's CRF head at the widths ``w``: the cost the mean of
    ``linear_chain_crf`` over the ``crfw`` transition, the prediction
    ``crf_decoding`` on it."""
    def seq_data(name):
        return L.data(name=name, shape=[1], dtype="int64", lod_level=1)

    feeds = [seq_data(n) for n in SRL_FEEDS]
    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, target = \
        feeds
    predicate_embedding = L.embedding(
        input=predicate, size=[w["preds"], w["word_dim"]],
        param_attr=ParamAttr(name="vemb"))
    mark_embedding = L.embedding(input=mark,
                                 size=[w["marks"], w["mark_dim"]])
    emb_layers = [L.embedding(size=[w["words"], w["word_dim"]], input=x,
                              param_attr=ParamAttr(name="word_emb"))
                  for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    emb_layers += [predicate_embedding, mark_embedding]
    hidden_0 = L.sums(input=[L.fc(input=emb, size=w["hidden"])
                             for emb in emb_layers])
    lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=w["hidden"],
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, w["depth"]):
        mix_hidden = L.sums(input=[
            L.fc(input=input_tmp[0], size=w["hidden"]),
            L.fc(input=input_tmp[1], size=w["hidden"])])
        lstm, _ = L.dynamic_lstm(input=mix_hidden, size=w["hidden"],
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]
    feature_out = L.sums(input=[
        L.fc(input=input_tmp[0], size=w["labels"]),
        L.fc(input=input_tmp[1], size=w["labels"])])
    crf_cost = L.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name="crfw",
                             learning_rate=w["mix_hidden_lr"]))
    avg_cost = L.mean(crf_cost)
    crf_decode = L.crf_decoding(input=feature_out,
                                param_attr=ParamAttr(name="crfw"))
    return {"cost": avg_cost, "feed_list": feeds, "prediction": crf_decode,
            "feature_out": feature_out, "target": target,
            "optimizer": optimizer.SGD(learning_rate=w["learning_rate"])}


def _sent_samples(kind):
    """BOOK_BATCHES batches of seeded synthetic reviews: ids in imdb's
    vocabulary, SENT's lengths, labels 0 / 1."""
    rng = np.random.RandomState(len(kind))
    out = []
    for _ in range(BOOK_BATCHES * BOOK_BATCH):
        n = rng.randint(SENT["min_len"], SENT["max_len"] + 1)
        out.append((rng.randint(0, SENT["vocab"], (n, 1)).astype(np.int64),
                    rng.randint(0, 2, (1,)).astype(np.int64)))
    return out


def srl_sample(rng, w=SRL):
    """One seeded synthetic CoNLL-05 row of the 9 ragged slots: words,
    the predicate's context of +-2 words broadcast over the sentence,
    the predicate id, the 0 / 1 mark of the words near it, the labels."""
    n = rng.randint(w["min_len"], w["max_len"] + 1)
    words = rng.randint(0, w["words"], n)
    v = rng.randint(0, n)

    def ctx(off):
        return np.full(n, words[min(max(v + off, 0), n - 1)])

    mark = (np.abs(np.arange(n) - v) <= 1).astype(np.int64)
    rows = [words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
            np.full(n, rng.randint(0, w["preds"])), mark,
            rng.randint(0, w["labels"], n)]
    return tuple(np.asarray(r, np.int64).reshape(-1, 1) for r in rows)


def _srl_samples():
    rng = np.random.RandomState(5)
    return [srl_sample(rng) for _ in range(BOOK_BATCHES * BOOK_BATCH)]


IMAGE_SHAPES = {"image_classification_vgg": (3, 32, 32),
                "recognize_digits_nets": (784,)}


def _image_samples(kind):
    """BOOK_BATCHES batches of seeded synthetic (image, label) samples of
    the dataset's shape, pixels in [0, 1)."""
    rng = np.random.RandomState(len(kind))
    n = BOOK_BATCHES * BOOK_BATCH
    imgs = rng.rand(n, *IMAGE_SHAPES[kind]).astype(np.float32)
    labels = rng.randint(0, 10, (n, 1)).astype(np.int64)
    return [(imgs[i], labels[i]) for i in range(n)]


def _book_reader(spec, samples, batch=BOOK_BATCH):
    """``spec`` with a reader of ``samples`` in batches of ``batch``."""
    spec["reader"] = lambda: (samples[i:i + batch] for i in range(
        0, len(samples), batch))
    return spec


def _cf_spec(kind, pkg):
    """A control flow kind's spec through ``pkg`` ("jax" or "port")."""
    L, opt, PA = ((jlayers, jpt.optimizer, jpt.ParamAttr) if pkg == "jax"
                  else (tlayers, toptimizer, TParamAttr))
    if kind == "rnn_encoder_decoder":
        return tmt.encoder_decoder(L, opt)
    return tmt.nmt_train(L, opt, PA)


def cf_samples(kind, n):
    """The first ``n`` rows of the JAX package's synthetic wmt14 at the
    kind's dictionary size."""
    from paddle_tpu.dataset import wmt14
    size = (tmt.ENCDEC if kind == "rnn_encoder_decoder"
            else tmt.NMT)["dict_size"]
    rows = []
    for row in wmt14.train(size)():
        rows.append(tuple(np.asarray(r, np.int64).reshape(-1, 1)
                          for r in row))
        if len(rows) == n:
            return rows
    return rows


def _port_spec(kind, **kind_kw):
    if kind in CF_KINDS:
        return _book_reader(_cf_spec(kind, "port"), cf_samples(
            kind, BOOK_BATCHES * CF_BATCH), batch=CF_BATCH)
    if kind in SENT_KINDS:
        return _book_reader(understand_sentiment(
            tlayers, tnets, toptimizer, kind.rsplit("_", 1)[1]),
            _sent_samples(kind))
    if kind == "label_semantic_roles":
        return _book_reader(label_semantic_roles(tlayers, toptimizer,
                                                 TParamAttr),
                            _srl_samples())
    if kind in IMAGE_KINDS:
        return _book_reader(globals()[kind](tlayers, tnets, toptimizer,
                                            **kind_kw), _image_samples(kind))
    if kind == "word2vec":
        spec = tw2v.model(vocab=W2V["vocab"], emb=W2V["emb"],
                          hidden=W2V["hidden"])
        spec["optimizer"] = toptimizer.SGD(learning_rate=W2V["learning_rate"])
        return _book_reader(spec, _w2v_samples())
    if kind == "recommender":
        return _book_reader(recommender(tlayers, toptimizer), _rec_samples())
    if kind == "fit_a_line":
        return tfit.model()
    if kind == "tiny_lm":
        return ttiny.model()
    if kind == "recognize_digits_conv":
        return tdigits.model()
    if kind == "resnet_cifar":
        return tresnet.model(samples=4 * RESNET["batch"], conv_impl="conv",
                             **RESNET)
    return trnn.model(lstm_impl="scan", samples=4 * RNN["batch"],
                      seq_len=8, **RNN)


def _jax_spec(kind, **kind_kw):
    if kind in CF_KINDS:
        return _cf_spec(kind, "jax")
    if kind in SENT_KINDS:
        return understand_sentiment(jlayers, jnets, jpt.optimizer,
                                    kind.rsplit("_", 1)[1])
    if kind == "label_semantic_roles":
        return label_semantic_roles(jlayers, jpt.optimizer, jpt.ParamAttr)
    if kind in IMAGE_KINDS:
        return globals()[kind](jlayers, jnets, jpt.optimizer, **kind_kw)
    if kind == "word2vec":
        return _jax_w2v()
    if kind == "recommender":
        return recommender(jlayers, jpt.optimizer)
    if kind == "resnet_cifar":
        return _jax_resnet()
    if kind == "text_rnn":
        return _jax_rnn()
    return jax_config(kind).model()


def prediction_name(kind, spec):
    """The name of the model's output before the loss: the fetch of an
    inference model."""
    if "prediction" in spec:
        return spec["prediction"].name
    cost_op = spec["cost"].op
    block = spec["cost"].block
    if kind == "fit_a_line":
        # mean(square_error_cost(fc)): the fc's output
        return block.var(cost_op.input("X")[0]).op.input("X")[0]
    if kind == "tiny_lm":
        # mean(softmax_with_cross_entropy(reshape(logits)))
        ce = block.var(cost_op.input("X")[0]).op
        return ce.input("Logits")[0]
    # mean(cross_entropy(softmax fc))
    ce = block.var(cost_op.input("X")[0]).op
    return ce.input("X")[0]


def build(pkg, kind, minimize=True, **kind_kw):
    """(main, startup, spec) of ``kind`` in ``pkg`` ('jax' or 'port'),
    with the optimizer's ops appended when ``minimize``; ``spec`` gains
    ``prediction_name``. ``kind_kw`` goes to an image kind's builder."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            spec = _jax_spec(kind, **kind_kw)
            spec["prediction_name"] = prediction_name(kind, spec)
            if minimize:
                spec["optimizer"].minimize(spec["cost"])
    else:
        main, start = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, start):
            spec = _port_spec(kind, **kind_kw)
            spec["prediction_name"] = prediction_name(kind, spec)
            if minimize:
                spec["optimizer"].minimize(spec["cost"])
    return main, start, spec


def _port_batches(kind):
    """The port config's reader's batches (lists of samples)."""
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        spec = _port_spec(kind)
    return list(spec["reader"]())


def batches(kind, n):
    """``n`` batches of samples from the port config's reader, cycled."""
    bs = _port_batches(kind)
    return [bs[i % len(bs)] for i in range(n)]


def reader_of(batches_):
    """A batched reader over ``batches_``."""
    return lambda: iter(list(batches_))


def make_trainer(pkg, kind, **kw):
    """(Trainer of ``kind`` in ``pkg`` on the CPU, spec): built, with its
    optimizer, under the package's name guard; the metrics of the
    config are its extra fetches."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            spec = _jax_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            tr = jpt.Trainer(spec["cost"], spec["optimizer"],
                             spec["feed_list"], place=jpt.CPUPlace(),
                             fetch_list=spec.get("metrics"),
                             main_program=main, startup_program=start,
                             **kw)
    else:
        from paddle_tpu_torch.trainer import Trainer
        main, start = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, start):
            spec = _port_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                         device="cpu", fetch_list=spec.get("metrics"),
                         main_program=main, startup_program=start, **kw)
    return tr, spec


def init_from(tr, pkg, state):
    """Run ``tr``'s startup without a restore, then install ``state``
    into the global scope."""
    tr._maybe_init(load=False)
    if pkg == "jax":
        for n, v in state.items():
            jpt.global_scope().set_var(n, v)
    else:
        from paddle_tpu_torch.core.scope import global_scope
        scope_from_numpy(state, device="cpu", scope=global_scope())


def feeds(kind, pkg, n):
    """``n`` feed dicts of numpy arrays (a ragged feed as ``pkg``'s
    LoDTensor), from the port config's reader, cycled."""
    batches = _port_batches(kind)
    names = {"fit_a_line": ("x", "y"), "tiny_lm": ("toks", "tgt"),
             "recognize_digits_conv": ("img", "label"),
             "resnet_cifar": ("img", "label"),
             "text_rnn": ("words", "label"),
             "word2vec": ("w0", "w1", "w2", "w3", "next_word"),
             "recommender": REC_FEEDS,
             "image_classification_vgg": ("pixel", "label"),
             "recognize_digits_nets": ("img", "label"),
             "understand_sentiment_conv": ("words", "label"),
             "understand_sentiment_lstm": ("words", "label"),
             "label_semantic_roles": SRL_FEEDS,
             **CF_FEEDS}[kind]
    lod_mod = jlod if pkg == "jax" else tlod
    out = []
    for i in range(n):
        b = batches[i % len(batches)]
        if kind == "text_rnn" or kind in SENT_KINDS:
            out.append({"words": lod_mod.build_lod_tensor([s[0] for s in b]),
                        "label": np.stack([s[1] for s in b])})
        elif kind == "label_semantic_roles" or kind in CF_KINDS:
            out.append({nm: lod_mod.build_lod_tensor([s[j] for s in b])
                        for j, nm in enumerate(names)})
        elif kind == "recommender":
            f = {nm: np.array([[s[j]] for s in b], np.int64)
                 for j, nm in enumerate(names[:5])}
            for j, nm in ((5, "category_id"), (6, "title_ids")):
                f[nm] = lod_mod.build_lod_tensor(
                    [np.array(s[j], np.int64).reshape(-1, 1) for s in b])
            f["score"] = np.stack([s[7] for s in b])
            out.append(f)
        else:
            out.append({nm: np.stack([s[j] for s in b])
                        for j, nm in enumerate(names)})
    return out


def persist_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def jax_startup_state(main, start):
    """The JAX startup's persistables of ``main`` as numpy."""
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor(jpt.CPUPlace()).run(start)
    return {n: np.asarray(scope.find_var(n)) for n in persist_names(main)
            if scope.find_var(n) is not None}


def jax_run(main, state, feeds_, fetch):
    """Run ``main`` over ``feeds_`` in the JAX package from ``state``:
    (each run's fetches as numpy, the final persistables)."""
    scope = jpt.Scope()
    exe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        outs = [[np.asarray(o) for o in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds_]
        final = {n: np.asarray(scope.find_var(n)) for n in state}
    return outs, final


def port_run(main, state, feeds_, fetch, use_jit=True):
    """The same in the port on the CPU."""
    exe, scope = TExecutor("cpu"), TScope()
    scope_from_numpy(state, device="cpu", scope=scope)
    outs = [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope, use_jit=use_jit)]
            for f in feeds_]
    return outs, scope_to_numpy(scope, names=state)


def rel(got, want):
    """The largest error over max(1, the largest magnitude of want)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1.0))


def loss_rel(got, want):
    """The largest relative error of a list of losses."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


# the line of the JAX package's while_grad (paddle_tpu/ops/control_flow_ops
# .py:643-644) that leaves out of the vjp a var the step block first
# writes in the loop's first iteration (absent from that snapshot)
JAX_WHILE_GRAD_LINE = ("if n in env_t and (n in cot or "
                       "_is_float_val(env_t.get(n)))]")


@contextlib.contextmanager
def jax_while_grad_first_write():
    """The JAX package's ``while_grad`` lowering with that one condition
    corrected (ROADMAP Queue 3 #36), installed in its registry for the
    block and restored after: a write with a cotangent is an output of
    the vjp whether or not the snapshot held it. Without it the JAX
    package drops the cotangent of a DynamicRNN's first output step. Its
    jitted steps are cached per program, so it must be installed before
    a program's first run."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.ops import control_flow_ops as jcf
    src = textwrap.dedent(inspect.getsource(jcf.while_grad))
    assert src.count(JAX_WHILE_GRAD_LINE) == 1
    src = src.replace(JAX_WHILE_GRAD_LINE, "if n in cot or (n in env_t and "
                      "_is_float_val(env_t.get(n)))]")
    ns = dict(vars(jcf))
    exec(src[src.index("def while_grad"):], ns)
    opdef = jreg.lookup_checked("while_grad")
    real, opdef.lower = opdef.lower, ns["while_grad"]
    try:
        yield
    finally:
        opdef.lower = real
