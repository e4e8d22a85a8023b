"""ResNet training on the card: ``TrainStep`` over ResNet-18 replays its
captured graph bit for bit as the step run op by op, BatchNorm's running
stats included, in f32 and at O1 bf16 (cuDNN deterministic). Skipped
without a CUDA device; this file imports no JAX, so it runs on the card
machine as it is.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import TrainStep


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("amp_on", [False, True], ids=["f32", "bf16_o1"])
def test_resnet18_replays_bitwise_with_batch_norm(cuda, amp_on):
    """Four ``TrainStep`` calls of ResNet-18 (one eager run and capture,
    three replays) against four op-by-op steps from the same seed, cuDNN
    deterministic: bitwise the same losses, weights, gradients, momenta
    and BN running stats, which moved every step."""
    import contextlib
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.rand(8, 3, 32, 32).astype(np.float32))
                .to(cuda), torch.from_numpy(rng.randint(0, 10, (8,)))
                .to(cuda)) for _ in range(4)]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sides = []
        for replay in (True, False):
            pt.seed(0)
            model = pt.vision.resnet18(num_classes=10, device=cuda)
            opt = pt.optimizer.Momentum(0.05, 0.9,
                                        parameters=model.parameters())
            ce = pt.nn.CrossEntropyLoss(label_smoothing=0.1)
            step = TrainStep(model, opt, lambda o, t: ce(o, t))
            call = step if replay else step._eager
            scope = pt.amp.auto_cast(level="O1") if amp_on \
                else contextlib.nullcontext()
            means = []
            with scope:
                losses = [float(call(x, y)) for x, y in batches
                          if not means.append(model.bn1._mean.clone())]
            state = [*model.parameters(), *(p.grad for p in
                                            model.parameters()),
                     *model.buffers(),
                     *(t for st in step.opt_state for t in st.values())]
            sides.append((losses, [t.detach().clone() for t in state],
                          step.graph_stats, means))
        (gl, gs, stats, gm), (el, es, _, _) = sides
        assert gl == el
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(gs, es))
        assert stats["captures"] == 1 and stats["replays"] == 3
        assert all(not torch.equal(a, b) for a, b in zip(gm, gm[1:]))
    finally:
        torch.backends.cudnn.deterministic = prev
