"""``chip_smoke.py``'s phase 18 helpers rehearsed on the CPU, at sizes
the CPU takes (the phase itself runs on the card at ImageNet widths):

- every case of ``_convnet_cases`` builds and runs on the per-op path,
  and ``_convnet_ops_check`` passes with the CPU on both sides (its
  dropout train-mask gates included);
- ``_plain_vgg16_loss`` (the plain VGG-16 the phase holds step 1's
  gradients to) agrees with the port's ``models.vgg16`` step, through
  ``_vgg_grad_check``, at 32 x 32 and batch 2, and the same model with
  its conv operands rounded to TF32 misses the phase's gate;
- ``_n_conv3x3`` counts 13 / 12, 10 / 10 and 3 / 3 conv3x3 forward / dx
  launches a step in VGG-16, GoogLeNet and AlexNet, and
  ``_conv3x3_convs`` gives the shapes at which ``_zoo_conv_check``
  holds the kernel to its plain version (VGG-16's nine, GoogLeNet's
  ten, AlexNet's three).

JAX-free: nothing of the JAX package is needed here.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _smoke():
    return importlib.import_module("chip_smoke")


def test_convnet_op_cases_pass_with_the_cpu_on_both_sides():
    per_op = _smoke()._convnet_ops_check(torch.device("cpu"))
    assert len(per_op) == 17
    for op, rec in per_op.items():
        assert rec["max_rel_err"] == 0.0, op
    assert set(per_op["dropout"]["train_mask"]) == {"cpu_p0.1", "cpu_p0.5"}
    assert "conv2d_grad" in per_op["depthwise_conv2d"]["grads"]
    assert "dropout_grad" in per_op["dropout"]["grads"]


def _program(name, image=224, class_dim=1000):
    from paddle_tpu_torch import layers, models
    from paddle_tpu_torch.core import ir, unique_name
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        img = layers.data("img", shape=[3, image, image], dtype="float32")
        lab = layers.data("label", shape=[1], dtype="int64")
        pred = getattr(models, name)(img, class_dim=class_dim)
        cost = layers.mean(layers.cross_entropy(pred, lab))
    return main, start, img, lab, cost


@pytest.mark.parametrize("name,want", [("vgg16", (13, 12)),
                                       ("googlenet", (10, 10)),
                                       ("alexnet", (3, 3))])
def test_conv3x3_launches_a_step_counted_from_the_program(name, want):
    main = _program(name)[0]
    assert _smoke()._n_conv3x3(main) == want


VGG16_CONV3X3 = {(32, 224, 224, 3, 64): False,
                 (32, 224, 224, 64, 64): True,
                 (32, 112, 112, 64, 128): True,
                 (32, 112, 112, 128, 128): True,
                 (32, 56, 56, 128, 256): True, (32, 56, 56, 256, 256): True,
                 (32, 28, 28, 256, 512): True, (32, 28, 28, 512, 512): True,
                 (32, 14, 14, 512, 512): True}


@pytest.mark.parametrize("name,distinct", [("vgg16", 9), ("googlenet", 10),
                                           ("alexnet", 3)])
def test_conv3x3_shapes_held_on_the_card_cover_every_conv(name, distinct):
    """(N, H, W, C, O) and whether the dx runs, of each conv the conv3x3
    population takes, at batch 32: one entry a conv, the distinct shapes
    those the phase holds the kernel at, the dx wherever the conv's input
    wants a gradient."""
    convs = _smoke()._conv3x3_convs(_program(name)[0], 32)
    assert len(convs) == _smoke()._n_conv3x3(_program(name)[0])[0]
    shapes = {}
    for shape, dx in convs:
        shapes[shape] = shapes.get(shape, False) or dx
    assert len(shapes) == distinct
    if name == "vgg16":
        assert shapes == VGG16_CONV3X3
    else:
        assert all(shapes.values())
    if name == "alexnet":
        assert {s[1:3] for s in shapes} == {(12, 12)}


def test_plain_vgg16_matches_the_port_step():
    """Step 1 of ``models.vgg16`` at 32 x 32 (one pixel after the fifth
    pool), batch 2, Momentum(0.1, 0.9), on the CPU: every parameter's
    gradient within the phase's gate of the plain model's autograd fed
    the step's masks; here, float32 on one device, within 2e-3 (the
    last block's batch norms see 2 values a channel, which makes its
    gradients sensitive to the sums' order: 3.8e-4 measured); the
    reference with TF32-rounded conv operands beyond the phase's gate
    (1.26 measured)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.trainer import Trainer
    smoke = _smoke()
    main, start, img, lab, cost = _program("vgg16", image=32)
    with unique_name.guard(), ir.program_guard(main, start):
        trainer = Trainer(cost, optimizer.Momentum(learning_rate=0.1,
                                                   momentum=0.9),
                          [img, lab], device="cpu")
    rng = np.random.RandomState(0)
    sample = [(rng.rand(3, 32, 32).astype(np.float32),
               rng.randint(0, 1000, (1,)).astype(np.int64))
              for _ in range(2)]
    with scope_guard(Scope()):
        trainer._maybe_init()
        rec = smoke._vgg_grad_check(trainer, {"cost": cost},
                                    trainer.feeder.feed(sample))
    # 13 conv filters, 14 batch-norm scales and biases, 3 fc weights and
    # biases; fc_0's bias, ahead of a batch norm, is zero but for noise
    assert rec["zero_grad_params"] == ["fc_0.b_0"]
    assert rec["params_checked"] == 13 + 2 * 14 + 6 - 1
    assert rec["norm_rel_err"] <= 2e-3, rec
    assert rec["loss_abs_err"] <= 1e-5, rec
    assert rec["tf32_convs_norm_rel_err"] > smoke.VGG_GRAD_REL_TOL, rec
