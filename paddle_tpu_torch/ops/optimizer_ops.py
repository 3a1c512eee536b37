"""Optimizers as ops (counterparts in ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :30, ``momentum`` :43, ``adam`` :60, and the update ops of the
other optimizers :111-246: ``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``ftrl``, ``proximal_gd`` and
``proximal_adagrad``). Each reads Param, Grad, LearningRate (all but
``adadelta``) and its accumulators and writes ParamOut (the same var as
Param) and its accumulators' outs, so the Executor's write-back carries
the update into the scope. Each keeps its own attr defaults, which may
differ from its optimizer class's (``rmsprop``'s op defaults are decay
0.9 and epsilon 1e-10, ``RMSPropOptimizer`` passes 0.95 and 1e-6).

The updates make new tensors; each is the JAX lowering's formula op for
op, in float32 on a float32 parameter. A SelectedRows gradient (a sparse
embedding's, ``selected_rows.py``) is made dense for every update but
two (``_grad``, :18-27): ``sgd`` adds its rows (:30-40), and Adam under
``lazy_mode`` updates only the looked-up rows and their moments
(:74-97); on a dense gradient ``lazy_mode`` computes the plain update.
Those two row updates write into the parameter in place inside a
compiled step, whose state tensors the step updates in place anyway,
so that a step over a large table moves only its looked-up rows; the
per-op path writes a new tensor.
The LearningRate var may be the output of a schedule
(``learning_rate_decay.py``); it is read as a device tensor, never as a
host number, so a captured step reads each step's value.
"""
from __future__ import annotations

import torch

from ..core.executor import in_compiled_step
from ..core.registry import register_op
from .selected_rows import SelectedRowsVal, sgd_selected_rows, unique_rows

__all__ = []


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _grad(ctx):
    """The gradient as a dense tensor: a SelectedRows value is added
    into zeros, the numbers of a dense gradient."""
    g = ctx.input("Grad")
    return g.to_dense() if isinstance(g, SelectedRowsVal) else g


@register_op("sgd", no_gradient=True, stateful_outputs=("ParamOut",))
def sgd(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    if isinstance(g, SelectedRowsVal):
        # only the looked-up rows move
        ctx.set_output("ParamOut", sgd_selected_rows(
            p, _lr(ctx), g, inplace=in_compiled_step()))
        return
    ctx.set_output("ParamOut", p - _lr(ctx) * g)


@register_op("momentum", no_gradient=True,
             stateful_outputs=("ParamOut", "VelocityOut"))
def momentum(ctx):
    """``v = mu * v + g``; ``p -= lr * v``, or with Nesterov
    ``p -= lr * (g + mu * v)``."""
    p = ctx.input("Param")
    g = _grad(ctx)
    mu = ctx.attr("mu")
    lr = _lr(ctx)
    v_new = mu * ctx.input("Velocity") + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam", no_gradient=True,
             stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out"))
def adam(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m1 = ctx.input("Moment1")
    m2 = ctx.input("Moment2")
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(ctx) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    if isinstance(g, SelectedRowsVal):
        if ctx.attr("lazy_mode", False):
            _lazy_adam(ctx, p, g, m1, m2, lr, b1, b2, eps)
            return
        # non-lazy: the untouched rows' moments decay too, the numbers
        # of the dense gradient
        g = g.to_dense()
    m1n = b1 * m1 + (1.0 - b1) * g
    m2n = b2 * m2 + (1.0 - b2) * g * g
    ctx.set_output("ParamOut", p - lr * m1n / (torch.sqrt(m2n) + eps))
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)


def _lazy_adam(ctx, p, g, m1, m2, lr, b1, b2, eps):
    """Adam on the looked-up rows only (``paddle_tpu/ops/optimizer_ops.py
    :74-97``). Duplicates are summed per row in lane order; the row set
    has the batch's fixed size, and its padding lanes (row == height in
    JAX, whose scatters drop them) point at the first distinct row and
    carry its new values, so no index leaves the table and no two
    writes to one row differ. ``index_add_`` on the card adds a row's
    duplicates with atomics, in an order that may change from run to
    run: such a row can differ from an eager run in its last bits."""
    height = p.shape[0]
    uniq, seg, perm = unique_rows(g.rows, height)
    gr = torch.zeros_like(g.values).index_add_(0, seg, g.values[perm])
    valid = uniq < height
    rows = torch.where(valid, uniq, uniq[:1])
    m1r = b1 * m1[rows] + (1.0 - b1) * gr
    m2r = b2 * m2[rows] + (1.0 - b2) * gr * gr
    pr = p[rows] - lr * m1r / (torch.sqrt(m2r) + eps)
    keep = valid.unsqueeze(1)
    inplace = in_compiled_step()
    for slot, t, new in (("ParamOut", p, pr), ("Moment1Out", m1, m1r),
                         ("Moment2Out", m2, m2r)):
        new = torch.where(keep, new, new[:1])
        ctx.set_output(slot, t.index_copy_(0, rows, new) if inplace
                       else t.index_copy(0, rows, new))


@register_op("adamax", no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut", "InfNormOut"))
def adamax(ctx):
    p = ctx.input("Param")
    g = _grad(ctx)
    m = ctx.input("Moment")
    inf = ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    mn = b1 * m + (1.0 - b1) * g
    infn = torch.maximum(b2 * inf, torch.abs(g))
    lr = _lr(ctx) / (1.0 - b1p)
    ctx.set_output("ParamOut", p - lr * mn / (infn + eps))
    ctx.set_output("MomentOut", mn)
    ctx.set_output("InfNormOut", infn)


@register_op("adagrad", no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut"))
def adagrad(ctx):
    p = ctx.input("Param")
    g = _grad(ctx)
    mn = ctx.input("Moment") + g * g
    eps = ctx.attr("epsilon", 1e-6)
    ctx.set_output("ParamOut", p - _lr(ctx) * g / (torch.sqrt(mn) + eps))
    ctx.set_output("MomentOut", mn)


@register_op("decayed_adagrad", no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut"))
def decayed_adagrad(ctx):
    p = ctx.input("Param")
    g = _grad(ctx)
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mn = decay * ctx.input("Moment") + (1.0 - decay) * g * g
    ctx.set_output("ParamOut", p - _lr(ctx) * g / (torch.sqrt(mn) + eps))
    ctx.set_output("MomentOut", mn)


@register_op("adadelta", no_gradient=True,
             stateful_outputs=("ParamOut", "AvgSquaredGradOut",
                               "AvgSquaredUpdateOut"))
def adadelta(ctx):
    """Reads no LearningRate: the step is sqrt((E[u^2] + eps) / (E[g^2]
    + eps)) * g."""
    p = ctx.input("Param")
    g = _grad(ctx)
    ag = ctx.input("AvgSquaredGrad")
    au = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    agn = rho * ag + (1.0 - rho) * g * g
    upd = -torch.sqrt((au + eps) / (agn + eps)) * g
    aun = rho * au + (1.0 - rho) * upd * upd
    ctx.set_output("ParamOut", p + upd)
    ctx.set_output("AvgSquaredGradOut", agn)
    ctx.set_output("AvgSquaredUpdateOut", aun)


@register_op("rmsprop", no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut", "MeanSquareOut"))
def rmsprop(ctx):
    p = ctx.input("Param")
    g = _grad(ctx)
    rho = ctx.attr("decay", 0.9)
    eps = ctx.attr("epsilon", 1e-10)
    mu = ctx.attr("momentum", 0.0)
    msn = rho * ctx.input("MeanSquare") + (1.0 - rho) * g * g
    momn = mu * ctx.input("Moment") + _lr(ctx) * g / torch.sqrt(msn + eps)
    ctx.set_output("ParamOut", p - momn)
    ctx.set_output("MomentOut", momn)
    ctx.set_output("MeanSquareOut", msn)


@register_op("ftrl", no_gradient=True,
             stateful_outputs=("ParamOut", "SquaredAccumOut",
                               "LinearAccumOut"))
def ftrl(ctx):
    """FTRL-proximal: ``sqrt`` where ``lr_power`` is -0.5, ``pow``
    otherwise, as the JAX lowering branches; the parameter is written
    afresh from the linear accumulator, not stepped."""
    p = ctx.input("Param")
    g = _grad(ctx)
    sq = ctx.input("SquaredAccumulator")
    lin = ctx.input("LinearAccumulator")
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    if lr_power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2.0 * l2
    else:
        denom = torch.pow(new_sq, -lr_power) / lr + 2.0 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    ctx.set_output("ParamOut", pre / denom)
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", new_lin)


def _prox(prox, lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                           min=0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", no_gradient=True, stateful_outputs=("ParamOut",))
def proximal_gd(ctx):
    lr = _lr(ctx)
    prox = ctx.input("Param") - lr * _grad(ctx)
    ctx.set_output("ParamOut", _prox(prox, lr, ctx.attr("l1", 0.0),
                                     ctx.attr("l2", 0.0)))


@register_op("proximal_adagrad", no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut"))
def proximal_adagrad(ctx):
    g = _grad(ctx)
    mn = ctx.input("Moment") + g * g
    lr = _lr(ctx) / torch.sqrt(mn + 1e-12)
    prox = ctx.input("Param") - lr * g
    ctx.set_output("ParamOut", _prox(prox, lr, ctx.attr("l1", 0.0),
                                     ctx.attr("l2", 0.0)))
    ctx.set_output("MomentOut", mn)
