"""The port's model zoo against the JAX package's on the CPU (twins of
``tests/test_models.py``'s ``test_mlp_trains``, ``test_vgg_cifar`` and
the three ``*_builds`` tests, and more):

- ``vgg16`` and ``alexnet`` and ``googlenet`` at 224 x 224, ``vgg_cifar``
  at 32 x 32, ``mlp`` and ``resnet_imagenet(depth=50)`` build main and
  startup programs equal op for op to the JAX package's, with the same
  parameter names (weights carry across by name).
- ``mlp`` trains 30 SGD steps in both from the JAX startup's state, the
  losses within 1e-5 relative (``torch_optim.LOSS_TOL``) and falling.
- The forward at ``is_test=True`` (dropout scales, batch norm reads its
  running statistics) from one seeded state (numpy, He-scaled weights,
  batch norm's statistics near 0 and 1; the JAX startup of GoogLeNet
  alone takes ~17 s on the CPU): ``vgg_cifar`` at batch 2,
  ``alexnet`` and ``googlenet`` at batch 1, the predictions within 1e-5
  of max(1, |the JAX value|).
- ``vgg_cifar`` in training mode (dropout draws, batch norm takes the
  batch's statistics) runs to a finite loss, as the JAX test holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu_torch import models as tmodels  # noqa: E402
from test_torch_convnet_layers import program_of  # noqa: E402
from torch_optim import (JAX, LOSS_TOL, PKGS, PORT, build,  # noqa: E402
                         jax_run, jax_startup_state, loss_rel, port_run, rel)

MODELS = {JAX.name: jmodels, PORT.name: tmodels}
FWD_TOL = 1e-5


def _classifier(name, shape, is_test=False, label=False, **kw):
    def fn(pkg):
        L = pkg.layers
        img = L.data("img", shape=shape, dtype="float32")
        pred = getattr(MODELS[pkg.name], name)(img, is_test=is_test, **kw)
        if not label:
            return pred
        lab = L.data("label", shape=[1], dtype="int64")
        return pred, L.mean(L.cross_entropy(pred, lab))
    return fn


def _mlp(pkg):
    L = pkg.layers
    x = L.data("x", shape=[64], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    pred, avg, acc = MODELS[pkg.name].mlp(x, label, hidden_sizes=(32,),
                                          class_num=4)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(avg)
    return avg


def _resnet50(pkg):
    img = pkg.layers.data("img", shape=[3, 224, 224], dtype="float32")
    return MODELS[pkg.name].resnet_imagenet(img, class_dim=1000, depth=50)


BUILDS = {
    "vgg16_224": _classifier("vgg16", [3, 224, 224], class_dim=1000),
    "vgg16_224_no_bn_is_test": _classifier(
        "vgg16", [3, 224, 224], is_test=True, class_dim=1000,
        with_bn=False),
    "vgg_cifar_32": _classifier("vgg_cifar", [3, 32, 32], label=True),
    "alexnet_224": _classifier("alexnet", [3, 224, 224]),
    "googlenet_224": _classifier("googlenet", [3, 224, 224]),
    "mlp": _mlp,
    "resnet50_224": _resnet50,
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_model_builds_the_jax_program(name):
    progs, params = {}, {}
    for pkg in PKGS:
        main, start, _ = build(pkg, BUILDS[name])
        progs[pkg.name] = program_of(main, start)
        params[pkg.name] = [p.name for p in main.all_parameters()]
    assert params["port"] == params["jax"] and params["port"]
    assert progs["port"] == progs["jax"]


def _n_ops(main, op_type):
    return sum(op.type == op_type for op in main.global_block().ops)


@pytest.mark.parametrize("name,classes,convs", [
    ("alexnet", 1000, 5), ("googlenet", 1000, 57), ("vgg16", 1000, 13)])
def test_imagenet_model_builds(name, classes, convs):
    """``test_alexnet_builds`` / ``test_googlenet_builds``'s twins (and
    vgg16's): the prediction is [N, classes]; the conv count."""
    main, _, pred = build(PORT, _classifier(name, [3, 224, 224]))
    assert pred.shape[-1] == classes
    assert _n_ops(main, "conv2d") == convs


def test_resnet50_imagenet_builds():
    main, _, pred = build(PORT, _resnet50)
    assert pred.shape[-1] == 1000 and _n_ops(main, "conv2d") == 53


def test_mlp_trains():
    """30 SGD steps at 0.1 on one batch in both packages from one state:
    the losses agree and fall."""
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 64).astype("float32")
    feed = {"x": xs, "label": (xs.sum(1, keepdims=True) > 32)
            .astype("int64")}
    jmain, jstart, javg = build(JAX, _mlp)
    tmain, _, tavg = build(PORT, _mlp)
    state = jax_startup_state(jmain, jstart)
    jl = [float(o[0].reshape(-1)[0]) for o in
          jax_run(jmain, state, [feed] * 30, [javg.name])[0]]
    tl = [float(o[0].reshape(-1)[0]) for o in
          port_run(tmain, state, [feed] * 30, [tavg.name])[0]]
    assert loss_rel(tl, jl) <= LOSS_TOL, (tl, jl)
    assert tl[-1] < tl[0]


def seeded_state(main, seed):
    """A value for every persistable of ``main``: weights normal with
    He's scale (fan-in the filter's C x kh x kw, an fc's rows), biases
    and running means 0.1-normal, batch-norm scales and variances
    near 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        if not v.persistable:
            continue
        shape = tuple(v.shape)
        if len(shape) >= 2:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif v.name.startswith("batch_norm") and v.name[-3:] in ("w_0",
                                                                "w_2"):
            a = 1.0 + 0.1 * rng.rand(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[v.name] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("name,shape,batch,kw", [
    ("vgg_cifar", [3, 32, 32], 2, {}),
    ("alexnet", [3, 224, 224], 1, {}),
    ("googlenet", [3, 224, 224], 1, {}),
], ids=["vgg_cifar", "alexnet", "googlenet"])
def test_forward_at_is_test_matches_jax(name, shape, batch, kw):
    fn = _classifier(name, shape, is_test=True, **kw)
    jmain, _, jpred = build(JAX, fn)
    tmain, _, tpred = build(PORT, fn)
    state = seeded_state(jmain, len(name))
    feed = {"img": np.random.RandomState(len(name)).rand(batch, *shape)
            .astype(np.float32)}
    want = jax_run(jmain, state, [feed], [jpred.name])[0][0][0]
    got = port_run(tmain, state, [feed], [tpred.name])[0][0][0]
    assert got.shape == want.shape == (batch, 1000 if name != "vgg_cifar"
                                       else 10)
    assert rel(got, want) <= FWD_TOL, rel(got, want)


def test_vgg_cifar():
    """Training mode at batch 2: the dropouts draw, batch norm takes the
    batch's statistics; the loss is finite."""
    tmain, _, (pred, avg) = build(PORT, _classifier(
        "vgg_cifar", [3, 32, 32], label=True))
    jmain, jstart, _ = build(JAX, _classifier("vgg_cifar", [3, 32, 32],
                                              label=True))
    state = jax_startup_state(jmain, jstart)
    rng = np.random.RandomState(1)
    feed = {"img": rng.rand(2, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    out, = port_run(tmain, state, [feed], [avg.name])[0][0]
    assert np.isfinite(out).all()
