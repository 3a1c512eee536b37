"""CTR models: wide&deep and DeepFM over sparse categorical slots
(counterpart of ``paddle_tpu/models/ctr.py``, op for op: ``wide_deep``
:37, ``deepfm`` :87, ``synthetic_click_batch`` :136).

Dense statistics and hashed categorical slots; every slot's embedding
carries ``is_sparse``, so its gradient is a SelectedRows value
(``ops/selected_rows.py``) and ``Adam(lazy_mode=True)`` moves only the
looked-up rows. ``is_distributed=True`` (a table row-sharded over a
mesh) is not ported and raises.
"""
from __future__ import annotations

from .. import layers

__all__ = ["deepfm", "synthetic_click_batch", "wide_deep"]


def _sparse_inputs(num_slots):
    return [layers.data(name="C%d" % i, shape=[1], dtype="int64",
                        lod_level=0)
            for i in range(num_slots)]


def _embed(ids, vocab_size, dim, name, is_sparse, is_distributed):
    from ..param_attr import ParamAttr
    if is_distributed:
        raise NotImplementedError(
            "is_distributed: a row-sharded lookup table is not ported "
            "(ROADMAP Queue 1 item 6f, distributed training); the port "
            "keeps every table on one device")
    return layers.embedding(
        input=ids, size=[vocab_size, dim], is_sparse=is_sparse,
        is_distributed=is_distributed,
        param_attr=ParamAttr(name=name))


def wide_deep(num_sparse_slots=26, dense_dim=13, vocab_size=10000,
              embed_dim=16, hidden_sizes=(400, 400, 400),
              is_sparse=True, is_distributed=False, with_auc=True):
    """Wide&Deep CTR: a linear ("wide") part over the raw slots plus a
    deep MLP over concatenated slot embeddings and dense features.

    Returns (avg_cost, auc_or_None, prob, feed_names).
    """
    dense = layers.data(name="dense_input", shape=[dense_dim],
                        dtype="float32")
    sparse = _sparse_inputs(num_sparse_slots)
    label = layers.data(name="click", shape=[1], dtype="float32")

    # deep tower: embeddings + dense stats -> MLP
    embs = [_embed(ids, vocab_size, embed_dim, "emb_C%d" % i,
                   is_sparse, is_distributed)
            for i, ids in enumerate(sparse)]
    deep = layers.concat(embs + [dense], axis=1)
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_logit = layers.fc(input=deep, size=1, act=None)

    # wide part: per-slot scalar weights (size-1 embeddings == the
    # one-hot linear term) + a linear map of the dense stats
    wide_terms = [_embed(ids, vocab_size, 1, "wide_C%d" % i,
                         is_sparse, is_distributed)
                  for i, ids in enumerate(sparse)]
    wide_logit = layers.fc(input=layers.concat(wide_terms, axis=1),
                           size=1, act=None)
    wide_logit = layers.elementwise_add(
        wide_logit, layers.fc(input=dense, size=1, act=None))

    logit = layers.elementwise_add(deep_logit, wide_logit)
    prob = layers.sigmoid(logit)
    cost = layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_cost = layers.mean(cost)
    auc_var = layers.auc(prob, label) if with_auc else None
    feeds = ["dense_input"] + ["C%d" % i for i in range(num_sparse_slots)] \
        + ["click"]
    return avg_cost, auc_var, prob, feeds


def deepfm(num_sparse_slots=26, dense_dim=13, vocab_size=10000,
           embed_dim=16, hidden_sizes=(400, 400),
           is_sparse=True, is_distributed=False, with_auc=True):
    """DeepFM: first-order linear term + pairwise FM interaction computed
    with the sum-square/square-sum identity (one matmul-free reduction,
    no O(slots^2) loop) + a deep MLP sharing the same
    embeddings.

    Returns (avg_cost, auc_or_None, prob, feed_names).
    """
    dense = layers.data(name="dense_input", shape=[dense_dim],
                        dtype="float32")
    sparse = _sparse_inputs(num_sparse_slots)
    label = layers.data(name="click", shape=[1], dtype="float32")

    embs = [_embed(ids, vocab_size, embed_dim, "fm_emb_C%d" % i,
                   is_sparse, is_distributed)
            for i, ids in enumerate(sparse)]
    firsts = [_embed(ids, vocab_size, 1, "fm_w_C%d" % i,
                     is_sparse, is_distributed)
              for i, ids in enumerate(sparse)]

    # first order
    first_order = layers.fc(input=layers.concat(firsts + [dense], axis=1),
                            size=1, act=None)

    # second order: 0.5 * sum((sum_i v_i)^2 - sum_i v_i^2)
    stacked = layers.concat(
        [layers.reshape(e, shape=[-1, 1, embed_dim]) for e in embs],
        axis=1)                                     # (N, slots, dim)
    sum_emb = layers.reduce_sum(stacked, dim=1)     # (N, dim)
    sum_sq = layers.elementwise_mul(sum_emb, sum_emb)
    sq = layers.elementwise_mul(stacked, stacked)
    sq_sum = layers.reduce_sum(sq, dim=1)
    fm = layers.reduce_sum(
        layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True)
    fm = layers.scale(fm, scale=0.5)

    deep = layers.concat(embs + [dense], axis=1)
    for h in hidden_sizes:
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_logit = layers.fc(input=deep, size=1, act=None)

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, fm), deep_logit)
    prob = layers.sigmoid(logit)
    cost = layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_cost = layers.mean(cost)
    auc_var = layers.auc(prob, label) if with_auc else None
    feeds = ["dense_input"] + ["C%d" % i for i in range(num_sparse_slots)] \
        + ["click"]
    return avg_cost, auc_var, prob, feeds


def synthetic_click_batch(rng, batch_size, num_sparse_slots=26,
                          dense_dim=13, vocab_size=10000):
    """Synthetic CTR batch with learnable structure: the click depends on
    a fixed random weighting of slot-hash parities and dense features, so
    AUC above 0.5 is achievable and loss must fall."""
    import numpy as np
    dense = rng.rand(batch_size, dense_dim).astype(np.float32)
    ids = [rng.randint(0, vocab_size, size=(batch_size, 1)).astype(np.int64)
           for _ in range(num_sparse_slots)]
    # deterministic signal: parity of a couple of slots + dense mean
    signal = ((ids[0] % 2).astype(np.float32)
              + (ids[1 % num_sparse_slots] % 3 == 0).astype(np.float32)
              + dense.mean(axis=1, keepdims=True))
    click = (signal + 0.3 * rng.randn(batch_size, 1)
             > np.median(signal)).astype(np.float32)
    feed = {"dense_input": dense, "click": click}
    for i, arr in enumerate(ids):
        feed["C%d" % i] = arr
    return feed
