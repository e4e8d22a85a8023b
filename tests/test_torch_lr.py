"""The port's LR schedulers (``optimizer.lr``) against the reference's, step
for step: each of the 17 schedules over 30 steps (the learning rate after
every ``step()``, then ``state_dict``), a restore into a fresh scheduler
that goes on as the original, and the optimizer reading the schedule
(``_lr_scheduler``, ``get_lr``). Host float arithmetic on both sides:
rtol 1e-12.
"""
import math

import pytest

import paddle_tpu.optimizer.lr as ref_lr

import paddle_tpu_torch as pt
import paddle_tpu_torch.optimizer.lr as port_lr

STEPS = 30

CASES = [
    ("NoamDecay", (64, 10), {}),
    ("NoamDecay", (512, 4, 2.0), {}),
    ("PiecewiseDecay", ([5, 12, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.1, 10, 1e-4, 2.0), {}),
    ("PolynomialDecay", (0.1, 7, 1e-4, 1.0, True), {}),
    ("LinearWarmup", (0.1, 5, 0.0, 0.1), {}),
    ("ExponentialDecay", (0.5, 0.9), {}),
    ("MultiStepDecay", (0.5, [3, 9, 20], 0.5), {}),
    ("StepDecay", (0.5, 4, 0.7), {}),
    ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    ("MultiplicativeDecay", (0.5, lambda e: 0.9 if e % 2 else 1.0), {}),
    ("CosineAnnealingDecay", (0.1, 12, 0.001), {}),
    ("CosineAnnealingWarmRestarts", (0.1, 4, 2, 0.001), {}),
    ("OneCycleLR", (0.1, 25), {}),
    ("OneCycleLR", (0.1, 25, 10.0, 1e-4, 0.25, "linear", True), {}),
    ("CyclicLR", (0.01, 0.1, 4), {}),
    ("CyclicLR", (0.01, 0.1, 3, 5, "triangular2"), {}),
    ("CyclicLR", (0.01, 0.1, 3), dict(mode="exp_range", exp_gamma=0.95)),
    ("LinearLR", (0.5, 10), {}),
    ("LinearLR", (0.5, 8, 0.1, 0.9), {}),
]


def _same_state(port, ref):
    a, b = port.state_dict(), ref.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12), k


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_schedule_equals_the_reference_step_for_step(name, args, kw):
    ref = getattr(ref_lr, name)(*args, **kw)
    port = getattr(port_lr, name)(*args, **kw)
    got, want = [port()], [ref()]
    for _ in range(STEPS):
        ref.step()
        port.step()
        got.append(port())
        want.append(ref())
    assert got == pytest.approx(want, rel=1e-12)
    assert all(isinstance(v, float) for v in got)
    _same_state(port, ref)
    # a fresh scheduler restored from the state goes on as the original
    fresh = getattr(port_lr, name)(*args, **kw)
    fresh.set_state_dict(port.state_dict())
    for _ in range(5):
        port.step()
        fresh.step()
        assert fresh() == pytest.approx(port(), rel=1e-12)


def test_piecewise_decay_boundaries():
    s = port_lr.PiecewiseDecay([2, 4], [1.0, 0.5, 0.25])
    seen = [s()]
    for _ in range(5):
        s.step()
        seen.append(s())
    assert seen == [1.0, 1.0, 0.5, 0.5, 0.25, 0.25]


def test_reduce_on_plateau_equals_the_reference():
    """A metric that stalls: the lr drops by ``factor`` after
    ``patience`` bad steps, then cools down, in both packages; a tensor
    metric is read back to the host."""
    import torch
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.8, 0.85, 0.9, 0.9, 0.9,
               0.9, 0.5, 0.6, 0.7, 0.7]
    for kw in (dict(patience=2, factor=0.5, cooldown=1),
               dict(mode="max", patience=1, threshold=0.01,
                    threshold_mode="abs", min_lr=0.02)):
        ref = ref_lr.ReduceOnPlateau(0.1, **kw)
        port = port_lr.ReduceOnPlateau(0.1, **kw)
        for m in metrics:
            ref.step(m)
            port.step(torch.tensor(m))
            assert port() == pytest.approx(ref(), rel=1e-12)
        _same_state(port, ref)
        assert port() < 0.1


def test_optimizer_reads_and_exposes_the_schedule():
    sched = port_lr.StepDecay(0.4, 2, 0.5)
    lin = pt.nn.Linear(2, 2, device="cpu")
    opt = pt.optimizer.Momentum(sched, parameters=lin.parameters())
    assert opt._lr_scheduler is sched
    for _ in range(3):
        sched.step()
    assert math.isclose(opt.get_lr(), 0.2)
    assert pt.optimizer.SGD(0.1, parameters=lin.parameters()) \
        ._lr_scheduler is None
    with pytest.raises(RuntimeError):
        opt.set_lr(0.3)
