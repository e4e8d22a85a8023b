"""Vision training on the card: ``TrainStep`` over ResNet-18 replays its
captured graph bit for bit as the step run op by op, BatchNorm's running
stats included, in f32 and at O1 bf16 (cuDNN deterministic); so do
SqueezeNet 1.1, MobileNet v3 small and GoogLeNet (three heads, the loss
their sum), whose dropout draws from the device generator inside the
graph; the DataLoader's workers feed the card the same augmented
batches in two runs from one seed; and a transform given an image on
the card gives it back there. Skipped without a CUDA device; this file
imports no JAX, so it runs on the card machine as it is.
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


def _replay_vs_eager(cuda, build, batches, loss_fn):
    """Four ``TrainStep`` calls (eager run and capture, three replays)
    against four op-by-op steps from one seed: (losses, state) of each
    side and the graph stats, cuDNN deterministic."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sides = []
        for replay in (True, False):
            pt.seed(0)
            model = build()
            opt = pt.optimizer.Momentum(0.05, 0.9,
                                        parameters=model.parameters())
            step = TrainStep(model, opt, loss_fn)
            call = step if replay else step._eager
            losses = [float(call(x, y)) for x, y in batches]
            state = [*model.parameters(), *model.buffers(),
                     *(t for st in step.opt_state for t in st.values())]
            sides.append((losses, [t.detach().clone() for t in state],
                          step.graph_stats))
        return sides
    finally:
        torch.backends.cudnn.deterministic = prev


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("squeezenet1_1", (8, 3, 64, 64)), ("mobilenet_v3_small", (8, 3, 64, 64)),
    ("googlenet", (4, 3, 224, 224))])
def test_zoo_model_replays_bitwise_with_dropout(cuda, name, shape):
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.rand(*shape).astype(np.float32))
                .to(cuda), torch.from_numpy(rng.randint(0, 10, shape[:1]))
                .to(cuda)) for _ in range(4)]
    ce = pt.nn.CrossEntropyLoss()

    def loss(*outs_and_label):
        # TrainStep passes a tuple output's parts one by one: GoogLeNet's
        # out, aux1, aux2, then the label
        *outs, y = outs_and_label
        return sum(ce(o, y) for o in outs)
    (gl, gs, stats), (el, es, _) = _replay_vs_eager(
        cuda, lambda: getattr(pt.vision.models, name)(num_classes=10,
                                                      device=cuda),
        batches, loss)
    assert gl == el and all(np.isfinite(gl))
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(gs, es))
    assert stats["captures"] == 1 and stats["replays"] == 3


@pytest.mark.cuda
def test_workers_feed_the_card(cuda):
    """Two workers run the ImageNet train transform and their batches land
    on the card in the sampler's order, the same in two runs from the
    same seed (each worker seeds Python's ``random``)."""
    T = pt.vision.transforms

    class Images(pt.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(0)
            self.x = rng.randint(0, 256, (12, 40, 36, 3)).astype(np.uint8)
            self.t = T.Compose([T.RandomResizedCrop(32),
                                T.RandomHorizontalFlip(),
                                T.Normalize([127.0] * 3, [64.0] * 3,
                                            data_format="HWC"),
                                T.Transpose()])

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.t(self.x[i]), np.int64(i)

    runs = []
    for _ in range(2):
        np.random.seed(0)
        runs.append(list(pt.io.DataLoader(Images(), places=cuda,
                                          batch_size=4, num_workers=2)))
    (a, b) = runs
    assert len(a) == 3 and a[0][0].device.type == "cuda"
    assert a[0][0].shape == (4, 3, 32, 32)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert [y.tolist() for _, y in a] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                          [8, 9, 10, 11]]


@pytest.mark.cuda
def test_tensor_transforms_stay_on_the_card(cuda):
    """A CHW image on the card goes through the functional transforms and
    ``Normalize`` on the host and comes back on the card, equal to the
    same call on the CPU tensor."""
    F = pt.vision.transforms.functional
    T = pt.vision.transforms
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(3, 20, 24).astype(np.float32))
    calls = [lambda x: F.resize(x, (10, 12)), F.hflip, F.vflip,
             lambda x: F.crop(x, 2, 3, 8, 9),
             lambda x: F.center_crop(x, 8), lambda x: F.pad(x, 2),
             lambda x: F.adjust_brightness(x, 1.3),
             lambda x: F.rotate(x, 30.0),
             lambda x: F.erase(x, 1, 2, 4, 5, torch.zeros(3, 4, 5)),
             T.Normalize([0.5] * 3, [0.25] * 3),
             lambda x: F.normalize(x, [0.5] * 3, [0.25] * 3)]
    for call in calls:
        want, got = call(img), call(img.to(cuda))
        assert got.device.type == cuda.type
        assert torch.equal(got.cpu(), want)
