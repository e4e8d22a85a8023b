"""``paddle.Model``, the callbacks, ``summary`` and ``flops`` of the port
on the CPU: a small CNN (Conv2D, BatchNorm2D, ReLU, the pools, Linear)
fitted and evaluated by the port's ``Model`` and the reference's from the
same weights and the same shuffled ``FakeData`` batches (losses, weights
and BN running stats at atol = rtol = 1e-4: four Momentum steps of
cuDNN-free f32 convolutions on both sides), a port-only ResNet-18
``fit`` / ``evaluate`` / ``save`` / ``load`` / ``predict`` round trip,
the callbacks' effects, and ``flops`` counting every convolution.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.vision.datasets import FakeData

TOL = dict(atol=1e-4, rtol=1e-4)


def _cnn(nn, **kw):
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, **kw), nn.BatchNorm2D(8, **kw),
        nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(8, 16, 3, stride=2, padding=1, bias_attr=False, **kw),
        nn.BatchNorm2D(16, **kw), nn.ReLU(), nn.AdaptiveAvgPool2D(1),
        nn.Flatten(), nn.Linear(16, 5, **kw))


class _Losses:
    """A callback of either package that records each logged loss."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def test_model_fit_evaluate_match_the_reference():
    paddle.seed(0)
    ref_net = _cnn(paddle.nn)
    port_net = _cnn(pt.nn, device="cpu")
    load_reference_state_dict(port_net, {
        k: np.asarray(v.numpy()) for k, v in ref_net.state_dict().items()})
    from paddle_tpu.vision.datasets import FakeData as RefFake
    sides = []
    for pkg, net, data in ((paddle, ref_net, RefFake(16, (3, 16, 16), 5)),
                           (pt, port_net, FakeData(16, (3, 16, 16), 5))):
        model = pkg.Model(net)
        opt = pkg.optimizer.Momentum(
            0.05, 0.9, parameters=net.parameters(),
            weight_decay=pkg.regularizer.L2Decay(1e-4))
        model.prepare(opt, pkg.nn.CrossEntropyLoss(label_smoothing=0.1),
                      pkg.metric.Accuracy(topk=(1, 2)))
        rec = type("Rec", (_Losses, pkg.callbacks.Callback), {})()
        np.random.seed(11)
        model.fit(data, batch_size=4, epochs=1, log_freq=1, verbose=0,
                  callbacks=[rec])
        logs = model.evaluate(data, batch_size=8, verbose=0)
        sides.append((rec.losses, logs, net))
    (rl, rlogs, _), (pl, plogs, _) = sides
    assert len(pl) == len(rl) == 4
    np.testing.assert_allclose(pl, rl, **TOL)
    assert plogs.keys() == rlogs.keys() == {"loss", "acc_top1", "acc_top2"}
    np.testing.assert_allclose(plogs["loss"], rlogs["loss"], **TOL)
    assert plogs["acc_top1"] == rlogs["acc_top1"]
    want = {k: np.asarray(v.numpy()) for k, v in ref_net.state_dict().items()}
    for k, a in export_reference_state_dict(port_net).items():
        np.testing.assert_allclose(a, want[k], err_msg=k, **TOL)


def test_eager_and_compiled_train_batch_agree():
    """``prepare(jit_compile=False)`` (forward, backward, ``step``,
    ``clear_grad``) and the ``TrainStep`` path take the same steps."""
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 3, 16, 16)
                         .astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    runs = []
    for jit in (True, False):
        pt.seed(3)
        net = _cnn(pt.nn, device="cpu")
        model = pt.Model(net).prepare(
            pt.optimizer.SGD(0.1, parameters=net.parameters()),
            pt.nn.CrossEntropyLoss(), jit_compile=jit)
        runs.append([model.train_batch([x], [y])[0][0] for _ in range(3)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)


def test_resnet18_fit_evaluate_save_load_predict(tmp_path):
    """ResNet-18 through ``Model`` on the CPU: ``fit`` (loss falls on a
    repeated batch, BN stats move), ``evaluate``, ``save``, ``load`` into
    a fresh model (same state, same eval loss), ``predict``."""
    pt.seed(0)
    net = pt.vision.resnet18(num_classes=4, device="cpu")
    data = FakeData(8, (3, 32, 32), 4)
    sched = pt.optimizer.lr.PiecewiseDecay([2], [0.02, 0.01])
    model = pt.Model(net).prepare(
        pt.optimizer.Momentum(sched, 0.9, parameters=net.parameters()),
        pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    rec = type("Rec", (_Losses, pt.callbacks.Callback), {})()
    model.fit(data, batch_size=8, epochs=4, log_freq=1, verbose=0,
              shuffle=False, callbacks=[rec])
    assert rec.losses[-1] < rec.losses[0]
    assert sched.last_epoch == 4 and sched() == 0.01
    assert float(net.bn1._variance.sum()) != 64.0
    logs = model.evaluate(data, batch_size=4, verbose=0)
    model.save(str(tmp_path / "ck" / "m"))
    assert os.path.exists(tmp_path / "ck" / "m.pdparams")
    assert os.path.exists(tmp_path / "ck" / "m.pdopt")
    pt.seed(1)
    other = pt.vision.resnet18(num_classes=4, device="cpu")
    fresh = pt.Model(other).prepare(
        pt.optimizer.Momentum(0.02, 0.9, parameters=other.parameters()),
        pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    fresh.load(str(tmp_path / "ck" / "m"))
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    again = fresh.evaluate(data, batch_size=4, verbose=0)
    assert again["loss"] == pytest.approx(logs["loss"], rel=1e-6)
    assert again["acc"] == logs["acc"]
    out = fresh.predict(data, batch_size=3, stack_outputs=True)
    assert out[0].shape == (8, 4)
    assert len(fresh.predict(data, batch_size=3)[0]) == 3


def test_callbacks():
    """``EarlyStopping`` stops ``fit``; ``ModelCheckpoint`` writes each
    epoch's and the final weights; ``VisualDL`` writes an event file;
    ``ReduceLROnPlateau`` lowers the optimizer's lr as the reference's
    does on the same logs; ``config_callbacks`` adds a progress logger
    and the LR-scheduler callback."""
    import tempfile
    pt.seed(0)
    net = _cnn(pt.nn, device="cpu")
    data = FakeData(8, (3, 16, 16), 5)
    opt = pt.optimizer.SGD(0.0, parameters=net.parameters())
    model = pt.Model(net).prepare(opt, pt.nn.CrossEntropyLoss())
    with tempfile.TemporaryDirectory() as d:
        stop = pt.callbacks.EarlyStopping(monitor="loss", patience=1)
        vdl = pt.callbacks.VisualDL(os.path.join(d, "vdl"))
        model.fit(data, data, batch_size=4, epochs=5, verbose=0,
                  save_dir=os.path.join(d, "ck"), callbacks=[stop, vdl])
        assert model.stop_training and stop.wait >= 1
        saved = sorted(os.listdir(os.path.join(d, "ck")))
        assert "final.pdparams" in saved and "0.pdparams" in saved
        assert os.listdir(os.path.join(d, "vdl"))
    logs_seq = [{"loss": [v]} for v in (1.0, 0.9, 0.95, 0.97, 0.99, 1.0)]
    lrs = []
    for pkg in (paddle, pt):
        lin = pkg.nn.Linear(2, 2)
        o = pkg.optimizer.SGD(0.1, parameters=lin.parameters())
        cb = pkg.callbacks.ReduceLROnPlateau(patience=2, factor=0.5,
                                             verbose=0)
        cb.set_model(type("M", (), {"_optimizer": o})())
        for logs in logs_seq:
            cb.on_eval_end(logs)
        lrs.append(o.get_lr())
    assert lrs[1] == pytest.approx(lrs[0]) and lrs[1] < 0.1
    cbs = pt.hapi.callbacks.config_callbacks(None, model=model, verbose=1)
    assert [type(c).__name__ for c in cbs] == ["ProgBarLogger",
                                               "LRScheduler"]


def test_summary_equals_the_reference_and_flops_counts_convolutions(capsys):
    paddle.seed(0)
    ref = pt.summary(_cnn(pt.nn, device="cpu"))
    want = paddle.summary(_cnn(paddle.nn))
    assert ref == want
    assert "Total params" in capsys.readouterr().out
    net = pt.vision.resnet50(device="cpu")
    assert pt.Model(net).summary()["total_params"] == 25_557_032
    # every convolution's and the classifier's multiply-adds, twice
    macs = []

    def hook(layer, inputs, out):
        if isinstance(layer, pt.nn.Conv2D):
            w = layer.weight
            macs.append(out.numel() * w[0].numel())
        elif isinstance(layer, pt.nn.Linear):
            macs.append(out.numel() * layer.weight.shape[1])
    handles = [m.register_forward_post_hook(hook) for m in net.sublayers()]
    with torch.no_grad():
        net.eval()(torch.zeros(1, 3, 224, 224))
    for h in handles:
        h.remove()
    assert pt.flops(net, [1, 3, 224, 224]) == 2 * sum(macs)
    assert 8.1e9 < 2 * sum(macs) < 8.3e9
    assert net.training is False


def test_fit_steps_the_schedule_at_logged_steps_only():
    """The reference's ``fit`` runs the callbacks' batch hooks every
    ``log_freq`` steps and at an epoch's last, so its ``LRScheduler``
    callback steps the schedule only there: 5 steps at ``log_freq=3``
    step it three times (steps 0, 3 and 4), in both packages."""
    seen = []
    for pkg, kw in ((paddle, {}), (pt, {"device": "cpu"})):
        net = pkg.nn.Linear(4, 3, **kw)
        sched = pkg.optimizer.lr.StepDecay(0.1, 1, 0.5)
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.SGD(sched, parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        rng = np.random.RandomState(0)
        batches = [(rng.rand(2, 4).astype(np.float32),
                    rng.randint(0, 3, (2,)).astype(np.int64))
                   for _ in range(5)]
        if pkg is pt:
            batches = [tuple(torch.from_numpy(a) for a in b)
                       for b in batches]
        else:
            batches = [tuple(paddle.to_tensor(a) for a in b)
                       for b in batches]
        model.fit(batches, epochs=1, log_freq=3, verbose=0)
        seen.append(sched.last_epoch)
    assert seen == [3, 3]


def test_eval_batch_unpacks_a_tuple_metric_result():
    """A metric whose ``compute`` returns a tuple gets it unpacked in
    ``update`` (upstream Paddle's call; the reference passes it whole)."""
    class Count(pt.metric.Metric):
        def reset(self):
            self.n = 0

        def update(self, outs, labels):
            self.n += int(labels.shape[0])

        def accumulate(self):
            return self.n

        def name(self):
            return "n"
    net = pt.nn.Linear(4, 3, device="cpu")
    m = Count()
    m.reset()
    model = pt.Model(net).prepare(None, pt.nn.CrossEntropyLoss(), m)
    x, y = torch.rand(5, 4), torch.tensor([0, 1, 2, 0, 1])
    loss, res = model.eval_batch([x], [y])
    assert res == [5] and len(loss) == 1
