"""Two ``TrainStep``s of ``mobilenet_v3_small`` and ``shufflenet_v2_x0_25``
in the port against the same steps in the reference, on the CPU, from
the same weights (``tests/test_torch_vision_models.py``'s helpers).

The steps run as ``test_torch_vision.py::
test_resnet50_train_step_matches_the_reference`` runs ResNet-50's:
Momentum(0.1, 0.9) with ``L2Decay(1e-4)`` on cross entropy with label
smoothing 0.1, from the same weights, in f64 (an f32 step of a freshly
drawn network is ill conditioned: see that test). MobileNet v3's
classifier dropout is set to 0 in both (the packages draw other masks
from one seed). Held: both losses to rtol 1e-9, and every weight and
BatchNorm running stat to 1e-8 of the change the reference's steps made
to it, plus 1e-12 for the tensors whose exact change is 0 (a BatchNorm's
shift followed by another BatchNorm: their change is rounding noise).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.bridge import TrainStep as RefStep

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.jit import TrainStep

from test_torch_vision_models import build_reference, shared_weights


def _no_dropout(model):
    for m in model.sublayers():
        if type(m).__name__ == "Dropout":
            m.p = 0.0


@pytest.mark.parametrize("name", ["mobilenet_v3_small",
                                  "shufflenet_v2_x0_25"])
def test_two_train_steps_match_the_reference(name):
    pt.seed(0)
    port = getattr(pt.vision.models, name)(num_classes=10, device="cpu")
    ref = build_reference(getattr(paddle.vision.models, name),
                          num_classes=10)
    shared_weights(port, ref, redraw_bn=False)
    init = {k: np.asarray(v.numpy(), np.float64)
            for k, v in ref.state_dict().items()}
    ref.to(dtype="float64")
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4, 3, 32, 32), rng.randint(0, 10, (4,)))
               for _ in range(2)]
    _no_dropout(ref)
    ropt = paddle.optimizer.Momentum(
        0.1, 0.9, parameters=ref.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    rce = paddle.nn.CrossEntropyLoss(label_smoothing=0.1)
    rstep = RefStep(ref, ropt, lambda o, t: rce(o, t))
    want_losses = [float(rstep(paddle.to_tensor(x), paddle.to_tensor(y)))
                   for x, y in batches]
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}

    load_reference_state_dict(port, init)
    port.to(dtype=torch.float64)
    _no_dropout(port)
    opt = pt.optimizer.Momentum(0.1, 0.9, parameters=port.parameters(),
                                weight_decay=pt.regularizer.L2Decay(1e-4))
    ce = pt.nn.CrossEntropyLoss(label_smoothing=0.1)
    step = TrainStep(port, opt, lambda o, t: ce(o, t))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches]
    got = export_reference_state_dict(port)
    assert list(got) == list(want)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-9)
    moved = 0
    for k, w in want.items():
        assert got[k].dtype == np.float64, k
        change = np.abs(w - init[k]).max()
        assert np.abs(got[k] - w).max() <= 1e-8 * change + 1e-12, k
        moved += change > 1e-6
    assert moved > len(want) // 2
