"""SelectedRows: the sparse row-subset gradient of an embedding
(counterpart of ``paddle_tpu/ops/selected_rows.py``: ``SelectedRowsVal``
:25, the ``lookup_table`` grad maker under ``is_sparse`` :45-61,
``lookup_table_sparse_grad`` :64-78, ``sgd_selected_rows`` :81-84, the
host op ``split_selected_rows`` :87-106).

``rows`` and ``values`` keep the batch's token count, so their shapes
are fixed by the feed signature and a captured step holds them as two
tensors. Duplicate rows are kept; the consumers merge them (``sum``
concatenates, ``to_dense`` and the SGD row update add, lazy Adam sums
them per row). ``rows`` is int64, where the JAX package's is int32
(Queue 3 #26: ids are int64 in the port).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import registry
from ..core.executor import raw_data
from ..core.ir import grad_var_name
from ..core.registry import register_op

__all__ = ["SelectedRowsVal", "sgd_selected_rows", "unique_rows"]


class SelectedRowsVal(object):
    """rows: int64 [n]; values: [n, dim]; height: the table's rows. On
    the host (a fetched value) rows and values are numpy arrays."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """The [height, dim] gradient, duplicates added in lane order."""
        if isinstance(self.values, np.ndarray):
            out = np.zeros(self.shape, self.values.dtype)
            np.add.at(out, np.asarray(self.rows), self.values)
            return out
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.rows, self.values)

    def map(self, fn):
        """The same rows with ``fn`` applied to rows and values."""
        return SelectedRowsVal(fn(self.rows), fn(self.values), self.height)

    def __repr__(self):
        return "SelectedRowsVal(n=%d, shape=%s)" % (
            int(self.rows.shape[0]), self.shape)


def _lookup_table_grad_maker(op, block, grad_of, no_grad):
    if not op.attr("is_sparse", False):
        from ..core.backward import default_grad_maker
        return default_grad_maker(op, block, grad_of, no_grad)
    g = grad_of.get(op.output("Out")[0])
    w_name = op.input("W")[0]
    if g is None or w_name in no_grad:
        return None
    return [("lookup_table_sparse_grad",
             {"Ids": list(op.input("Ids")), "W": [w_name],
              "Out@GRAD": [g]},
             {"W@GRAD": [grad_var_name(w_name)]},
             {"padding_idx": op.attr("padding_idx", -1)})]


registry.lookup_checked("lookup_table").grad_maker = _lookup_table_grad_maker


@register_op("lookup_table_sparse_grad", no_gradient=True)
def lookup_table_sparse_grad(ctx):
    """W@GRAD as SelectedRows(ids, Out@GRAD): the table's gradient is
    never made dense. A lane at ``padding_idx`` carries zeros."""
    w = ctx.input("W")
    ids = raw_data(ctx.input("Ids")).reshape(-1).long()
    dim = w.shape[1]
    vals = raw_data(ctx.input("Out@GRAD")).reshape(-1, dim)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = vals * (ids != padding_idx).unsqueeze(1).to(vals.dtype)
    ctx.set_output("W@GRAD", SelectedRowsVal(ids, vals, w.shape[0]))


def sgd_selected_rows(param, lr, grad: SelectedRowsVal, inplace=False):
    """``param[rows] -= lr * values``, duplicates added. ``inplace``
    writes into ``param`` (the compiled step's state tensor)."""
    step = -lr * grad.values
    if inplace:
        return param.index_add_(0, grad.rows, step)
    return param.index_add(0, grad.rows, step)


def unique_rows(rows, height):
    """The duplicate-free row set of ``rows`` at the fixed size n = its
    length, without a host read (``torch.unique`` has a data-dependent
    size): a stable sort, a first-occurrence mask and its cumulative sum.
    Returns (uniq, seg, perm): ``uniq`` [n] holds the distinct rows in
    ascending order, then ``height`` in the lanes past them; lane
    ``perm[i]`` of ``rows`` belongs to ``uniq[seg[i]]``."""
    n = rows.shape[0]
    srt, perm = torch.sort(rows, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(first, 0) - 1
    uniq = torch.full((n,), height, dtype=rows.dtype, device=rows.device)
    # every lane of a segment writes the same row, so the repeated
    # index keeps one value whichever write lands
    uniq.scatter_(0, seg, srt)
    return uniq, seg, perm


@register_op("split_selected_rows", host=True, no_gradient=True)
def split_selected_rows(ctx):
    """The SelectedRows value cut by ``height_sections`` row ranges, each
    output's rows rebased to its section's start (the pserver sharding
    primitive). Which rows fall where depends on the data, so this runs
    on the host, as the runtime-shape sequence ops do."""
    x = ctx.input("X")
    sections = [int(s) for s in ctx.attr("height_sections", [])]
    if not sections:
        sections = [x.height]
    starts = np.cumsum([0] + sections)
    rows = x.rows.cpu().numpy() if isinstance(x.rows, torch.Tensor) \
        else np.asarray(x.rows)
    vals = x.values
    dev = vals.device if isinstance(vals, torch.Tensor) else ctx.device
    vals = torch.as_tensor(vals, device=dev)
    for i in range(len(sections)):
        m = np.nonzero((rows >= starts[i]) & (rows < starts[i + 1]))[0]
        ctx.set_output("Out", SelectedRowsVal(
            torch.as_tensor(rows[m] - starts[i], dtype=torch.int64,
                            device=dev),
            vals[torch.as_tensor(m, dtype=torch.int64, device=dev)],
            sections[i]), idx=i)
