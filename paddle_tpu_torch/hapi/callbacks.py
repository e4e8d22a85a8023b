"""``paddle.callbacks`` (counterpart of ``paddle_tpu/hapi/callbacks.py``,
copied: it is host code): ``Callback``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``, ``VisualDL``
(TensorBoard event files through ``utils.tbwriter``),
``ReduceLROnPlateau`` and ``config_callbacks``, which ``Model.fit``
calls."""
from __future__ import annotations

import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"step {step + 1}/{self.steps or '?'} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            items = " - ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1} done in {dur:.1f}s - {items}")


def _fmt(v):
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.stop_training = False

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        better = (self.best is None or
                  (cur < self.best - self.min_delta if self.mode == "min"
                   else cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, metrics=None, save_freq=1, save_dir=None):
    cbs = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbs) and verbose:
        cbs.append(ProgBarLogger(verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbs):
        cbs.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbs):
        cbs.append(LRScheduler())
    params = {"epochs": epochs, "steps": steps, "verbose": verbose,
              "metrics": metrics or []}
    for c in cbs:
        c.set_model(model)
        c.set_params(params)
    return cbs


class VisualDL(Callback):
    """Train and eval metrics as TensorBoard event files
    (``utils.tbwriter.LogWriter``: VisualDL's import and TensorBoard both
    read them)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self._log_dir = log_dir
        self._writer = None
        self._train_step = 0
        self._epoch = 0

    def _w(self):
        if self._writer is None:
            from ..utils.tbwriter import LogWriter
            self._writer = LogWriter(logdir=self._log_dir)
        return self._writer

    def _log(self, prefix, logs, step):
        for k, v in (logs or {}).items():
            try:
                vals = v if isinstance(v, (list, tuple)) else [v]
                for i, vv in enumerate(vals):
                    tag = f"{prefix}/{k}" if len(vals) == 1 \
                        else f"{prefix}/{k}_{i}"
                    self._w().add_scalar(tag, float(vv), step)
            except (TypeError, ValueError):
                pass

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._log("batch", logs, self._train_step)

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        self._log("train", logs, epoch)

    def on_eval_end(self, logs=None):
        self._log("eval", logs, self._epoch)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None  # a later fit() opens a new file


class ReduceLROnPlateau(Callback):
    """Shrink the optimizer's lr by ``factor`` when the monitored metric
    has not improved for ``patience`` checks."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._mode = ("min" if mode == "auto" and "loss" in monitor
                      else ("max" if mode == "auto" else mode))
        self._best = None
        self._wait = 0
        self._cool = 0

    def _better(self, cur):
        if self._best is None:
            return True
        if self._mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    def on_eval_end(self, logs=None):
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cool > 0:
            self._cool -= 1
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        if self._cool > 0:
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = float(opt.get_lr())
                new = max(lr * self.factor, self.min_lr)
                if new < lr:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {lr:.3g} -> "
                              f"{new:.3g}")
            self._wait = 0
            self._cool = self.cooldown
