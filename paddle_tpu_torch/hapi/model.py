"""``paddle.Model`` and ``paddle.summary`` (counterpart of
``paddle_tpu/hapi/model.py``).

``prepare`` takes the optimizer, loss and metrics; with ``jit_compile``
(the default) ``train_batch`` runs a ``jit.TrainStep`` built at its first
call, so on the card ``fit`` replays one CUDA graph per batch signature
(the reference's one compiled XLA program a signature) and on the CPU
runs the step op by op. ``fit`` / ``evaluate`` / ``predict`` wrap a
``Dataset`` in an ``io.DataLoader`` whose batches land on the device of
the network's first parameter. ``train_batch`` and ``eval_batch`` read
each loss back to the host, as the reference does.

``prepare`` returns the model (the reference returns None), so
``Model(net).prepare(...).fit(...)`` chains; ``amp_configs`` is taken
and, as there, not read: run ``fit`` under ``amp.auto_cast``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework_io import load as pload
from ..framework_io import save as psave
from . import callbacks as cb_mod

__all__ = ["Model", "summary"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._jit = True
        self._train_step = None
        self.stop_training = False

    @property
    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    # ------------------------------------------------------------ prepare --
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        self._jit = jit_compile
        self._train_step = None   # built at the first train_batch
        return self

    # ----------------------------------------------------------- training --
    def train_batch(self, inputs, labels=None, update=True):
        """One step on ``inputs`` / ``labels``; returns ([loss], []).
        ``update=False`` leaves the gradients for a later step (without
        ``jit_compile``; the compiled step always updates, as the
        reference's)."""
        inputs, labels = _as_list(inputs), _as_list(labels)
        if self._jit:
            if self._train_step is None:
                from ..jit.bridge import TrainStep
                self._train_step = TrainStep(
                    self.network, self._optimizer,
                    lambda out, *ys: self._loss(out, *ys),
                    n_model_inputs=len(inputs))
            loss = self._train_step(*inputs, *labels)
        else:
            loss = self._loss(self.network(*inputs), *labels)
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        return [float(loss.detach())], []

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """([loss] or [], each metric's running value) on one batch."""
        inputs, labels = _as_list(inputs), _as_list(labels)
        outs = self.network(*inputs)
        loss = self._loss(outs, *labels) if self._loss else None
        metric_res = []
        for m in self._metrics:
            res = m.compute(outs, *labels)
            if isinstance(res, tuple):
                m.update(*res)
            else:
                m.update(res)
            metric_res.append(m.accumulate())
        return ([float(loss)] if loss is not None else []), metric_res

    @torch.no_grad()
    def predict_batch(self, inputs):
        out = self.network(*_as_list(inputs))
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        return [out]

    def _loader(self, data, batch_size, num_workers, shuffle=False,
                drop_last=False):
        from ..io import DataLoader, Dataset
        if not isinstance(data, Dataset):
            return data
        return DataLoader(data, places=self._device, batch_size=batch_size,
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=num_workers)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """``epochs`` passes over ``train_data`` (a ``Dataset`` or an
        iterable of (inputs, labels) batches), at most ``num_iters``
        steps in all; ``evaluate`` on ``eval_data`` every ``eval_freq``
        epochs. The callbacks' batch hooks run every ``log_freq`` steps
        and at an epoch's last step, as the reference runs them (so the
        ``LRScheduler`` callback steps the schedule there).
        ``accumulate_grad_batches`` is taken and, as there, not read."""
        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle, drop_last)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbs = cb_mod.config_callbacks(callbacks, model=self, epochs=epochs,
                                      steps=steps, verbose=verbose,
                                      save_dir=save_dir, save_freq=save_freq,
                                      metrics=self._metrics)
        self.stop_training = False
        for cb in cbs:
            cb.on_train_begin()
        it_count = 0
        for epoch in range(epochs):
            self.network.train()
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                for cb in cbs:
                    cb.on_train_batch_begin(step)
                x, y = self._split_batch(batch)
                loss, _ = self.train_batch(x, y)
                logs = {"loss": loss[0]}
                if step % log_freq == 0 or (steps and step + 1 == steps):
                    for cb in cbs:
                        cb.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters and it_count >= num_iters:
                    break
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers)
                for cb in cbs:
                    cb.on_eval_end(eval_logs)
            if self.stop_training or (num_iters and it_count >= num_iters):
                break
        for cb in cbs:
            cb.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean loss (as a one-element list) and every metric's value
        over ``eval_data``, in eval mode."""
        loader = self._loader(eval_data, batch_size, num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            x, y = self._split_batch(batch)
            loss, _ = self.eval_batch(x, y)
            if loss:
                losses.append(loss[0])
        logs = {}
        if losses:
            logs["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            name, res = m.name(), m.accumulate()
            if isinstance(name, list):
                logs.update(zip(name, res))
            else:
                logs[name] = res
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs over ``test_data`` as numpy arrays, one
        per batch (``stack_outputs``: concatenated)."""
        loader = self._loader(test_data, batch_size, num_workers)
        self.network.eval()
        outputs = []
        for batch in loader:
            x, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(x)[0])
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return batch[0], batch[1]
            return batch[0], None
        return batch, None

    # ------------------------------------------------------------ save/io --
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load what ``save`` wrote, in place (the optimizer's state too
        unless ``reset_optimizer``)."""
        self.network.set_state_dict(pload(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(pload(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)


def summary(net, input_size=None, dtypes=None, input=None):
    """Print each parameter's name, shape and size and the totals; return
    ``{"total_params": ..., "trainable_params": ...}``. ``input_size``,
    ``dtypes`` and ``input`` are taken and, as in the reference, not
    read."""
    total_params = 0
    trainable = 0
    rows = []
    for name, p in net.named_parameters():
        n = p.numel()
        total_params += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    lines = ["-" * 64,
             f"{'Param name':<36}{'Shape':<18}{'#':>10}",
             "-" * 64]
    for name, shape, n in rows:
        lines.append(f"{name:<36}{str(shape):<18}{n:>10}")
    lines += ["-" * 64,
              f"Total params: {total_params:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total_params - trainable:,}",
              "-" * 64]
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable}
