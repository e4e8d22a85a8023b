"""Pretraining Trainer (counterpart of ``paddle_tpu/trainer/__init__.py``).

The loop: restore the newest verified checkpoint, run ``TrainStep`` per
batch, check each loss for anomalies (NaN/Inf, or a spike against the
rolling mean of recent good losses) one step late so the host does not
wait on the device every step, checkpoint every ``save_steps`` (never an
anomalous step: the save is owed to the next good one), and on SIGTERM or
SIGINT checkpoint and return at the next step boundary.

Telemetry is the reference's (``observability``): one ``train.step``
span per step with ``train.data``, ``train.dispatch`` and
``train.loss_sync`` children, a ``train.anomaly_skip`` span and the
``robustness.anomalies_skipped`` counter per anomalous step, the
``train.loss`` and ``robustness.goodput`` gauges at log boundaries, a
registry snapshot to the JSONL sink per logged step (``maybe_export``),
a flight dump when anomalies abort the run or a signal preempts it, and
a ``RankHeartbeat`` when ``PADDLE_RANK_HEARTBEAT`` names its file. The
fault-injection sites and the distributed steps (DistTrainStep, fleet)
are not ported.
"""
from __future__ import annotations

import hashlib
import logging
import math
import os
import signal
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .. import observability as _obs
from ..framework.flags import flag_value as _fv

__all__ = ["TrainingArguments", "Trainer", "SpeedMeter",
           "device_peak_flops", "AnomalousTrainingError"]

# dense bf16 peak FLOP/s by device name (NVIDIA's data sheet, SXM part)
_PEAK_BF16 = {"h100": 989e12}


class AnomalousTrainingError(RuntimeError):
    """Training aborted after FLAGS_max_anomalous_steps consecutive NaN/Inf
    or loss-spike steps. The last verified checkpoint is intact:
    anomalous steps are never checkpointed."""


def device_peak_flops(dtype: str = "bfloat16") -> float:
    """Peak FLOP/s of the local accelerator for MFU accounting, keyed on
    ``torch.cuda.get_device_name``: the bf16/f16 dense peak, half of it
    for other dtypes (the reference's rule); 1e12 when the card is not
    known or there is none."""
    if not torch.cuda.is_available():
        return 1e12
    kind = torch.cuda.get_device_name(0).lower()
    for k, v in _PEAK_BF16.items():
        if k in kind:
            return v if dtype in ("bfloat16", "float16") else v / 2
    return 1e12


@dataclass
class SpeedMeter:
    """Rolling tokens/s and MFU (6 * N FLOPs per token over the peak)."""
    n_params: int
    n_devices: int = 1
    dtype: str = "bfloat16"
    window: int = 20
    _times: list = field(default_factory=list)
    _tokens: list = field(default_factory=list)

    def update(self, tokens: int):
        self._times.append(time.perf_counter())
        self._tokens.append(tokens)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._tokens.pop(0)

    @property
    def tokens_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._tokens[1:]) / dt if dt > 0 else 0.0

    @property
    def mfu(self) -> float:
        peak = device_peak_flops(self.dtype) * self.n_devices
        return (6.0 * self.n_params * self.tokens_per_sec) / peak


@dataclass
class TrainingArguments:
    """The reference's fields up to ``max_checkpoints``, in its order
    (its parallel degrees, which follow, are not ported: the port trains
    on one device). ``seed`` is kept and, as in the reference, not read
    by the loop: the caller seeds (``framework.random.seed``)."""
    output_dir: str = "output"
    max_steps: int = 1000
    logging_steps: int = 10
    save_steps: int = 100
    seed: int = 42
    bf16: bool = False
    max_checkpoints: int = 3


class Trainer:
    """Pretrain loop over ``TrainStep``. ``data_iter_fn(start_step)``
    returns an iterator of batches (tuples of tensors or arrays, moved
    to the model's device). ``train()`` returns a dict with the final
    step and loss, speed stats and the logged records. Resume is
    automatic: a verified checkpoint in ``output_dir/checkpoints`` is
    continued from. Like the reference, the loop never steps an LR
    scheduler."""

    def __init__(self, model, optimizer, loss_fn: Callable,
                 args: TrainingArguments, data_iter_fn: Callable,
                 tokens_per_batch: Optional[int] = None):
        from ..jit.bridge import TrainStep
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.args = args
        self.data_iter_fn = data_iter_fn
        self.tokens_per_batch = tokens_per_batch
        self._preempted = False
        self._ckpt = None
        self._step_obj = TrainStep(model, optimizer, loss_fn)

    # ------------------------------------------------------- checkpointing --
    def _ckpt_mgr(self):
        if self._ckpt is None:
            from ..distributed.checkpoint import VerifiedCheckpointer
            self._ckpt = VerifiedCheckpointer(
                os.path.join(self.args.output_dir, "checkpoints"),
                max_to_keep=self.args.max_checkpoints)
        return self._ckpt

    def _opt_leaves(self):
        """Optimizer state as (structure key, tensor) pairs in a fixed
        order: parameter by parameter, accumulators by name."""
        return [(f"{i}.{k}", st[k])
                for i, st in enumerate(self._step_obj.opt_state)
                for k in sorted(st)]

    def _full_state(self, step: int):
        leaves = self._opt_leaves()
        return {"model": dict(self.model.state_dict()),
                "step": torch.tensor(step, dtype=torch.int64),
                "opt": {str(i): t for i, (_, t) in enumerate(leaves)}}

    def _opt_fingerprint(self) -> str:
        """Fingerprint of the optimizer state's structure (keys, shapes,
        dtypes), kept in the manifest: leaves are stored by index, so a
        different optimizer must fail loudly instead of mis-restoring."""
        desc = "|".join(f"{k}:{tuple(t.shape)}:{t.dtype}"
                        for k, t in self._opt_leaves())
        return hashlib.sha256(desc.encode()).hexdigest()[:16]

    def _save(self, step: int):
        self._ckpt_mgr().save(step, self._full_state(step),
                              meta={"opt_treedef": self._opt_fingerprint()})

    def _try_resume(self) -> int:
        res = self._ckpt_mgr().restore_latest()
        if res is None:
            return 0
        step, restored, meta = res
        fp, cur = meta.get("opt_treedef"), self._opt_fingerprint()
        if fp is not None and fp != cur:
            raise RuntimeError(
                f"checkpoint step {step} was written with a different "
                f"optimizer state structure (fingerprint {fp} != current "
                f"{cur}): restoring by leaf index would silently "
                "mis-restore. Rebuild the Trainer with the original "
                "optimizer configuration, or start fresh with "
                "train(resume=False).")
        leaves = self._opt_leaves()
        if len(restored["opt"]) != len(leaves):
            raise RuntimeError(
                f"checkpoint step {step} holds {len(restored['opt'])} "
                f"optimizer leaves but the current optimizer has "
                f"{len(leaves)}: the optimizer changed between runs.")
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                if k in restored["model"]:
                    v.copy_(restored["model"][k])
            for i, (_, t) in enumerate(leaves):
                t.copy_(restored["opt"][str(i)])
        return int(restored["step"])

    # ---------------------------------------------------------- signals --
    _PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def _install_preemption_hook(self):
        """SIGTERM/SIGINT -> checkpoint and return at the next step
        boundary; chains to a handler installed before, and is undone
        when ``train`` returns."""
        self._prev_handlers = {}

        def handler(signum, frame):
            self._preempted = True
            prev = self._prev_handlers.get(signum)
            if callable(prev) and prev is not signal.default_int_handler:
                prev(signum, frame)

        for s in self._PREEMPT_SIGNALS:
            try:
                self._prev_handlers[s] = signal.signal(s, handler)
            except ValueError:
                pass  # not the main thread

    def _restore_preemption_hook(self):
        for s, prev in getattr(self, "_prev_handlers", {}).items():
            if prev is None:
                continue
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev_handlers = {}

    # -------------------------------------------------------- anomaly guard --
    def _guard_check(self, step: int, loss, parent=None) -> bool:
        """Read one step's loss and classify it: True when it is anomalous
        (NaN/Inf, or a spike against the rolling mean of recent good
        losses). Too many consecutive anomalies raise
        AnomalousTrainingError."""
        with _obs.span("train.loss_sync", parent=parent, step=step + 1):
            lv = float(loss)
        anomalous, reason = not math.isfinite(lv), "nonfinite"
        spike = float(_fv("loss_spike_factor"))
        window = self._good_losses
        if not anomalous and spike > 0 and len(window) >= 5:
            mean = sum(window) / len(window)
            if abs(lv) > spike * max(abs(mean), 1e-12):
                anomalous, reason = True, "spike"
        if anomalous:
            self._anom_consec += 1
            self._anom_total += 1
            _obs.counter("robustness.anomalies_skipped").inc(reason=reason)
            _obs.start_span("train.anomaly_skip", parent=None,
                            step=step + 1, reason=reason,
                            consecutive=self._anom_consec).end()
            self._log({"anomalous_step": step + 1, "loss": lv,
                       "reason": reason, "consecutive": self._anom_consec})
            if self._anom_consec >= int(_fv("max_anomalous_steps")):
                _obs.flight_dump(reason="anomalous_training")
                raise AnomalousTrainingError(
                    f"aborting after {self._anom_consec} consecutive "
                    f"anomalous steps (last loss {lv!r} at step {step + 1}, "
                    f"reason {reason}); the newest verified checkpoint is "
                    f"step {self._ckpt_mgr().latest_verified()}. Lower the "
                    "learning rate, inspect the data at this step range, "
                    "or raise FLAGS_max_anomalous_steps.")
        else:
            self._anom_consec = 0
            window.append(lv)
        return anomalous

    # ------------------------------------------------------------ the loop --
    def train(self, resume: bool = True):
        os.makedirs(self.args.output_dir, exist_ok=True)
        self._install_preemption_hook()
        # per-rank liveness: a launcher names each worker's heartbeat
        # file; silence there reads as a wedged rank
        self._hb = None
        hb_path = os.environ.get("PADDLE_RANK_HEARTBEAT")
        if hb_path:
            self._hb = _obs.RankHeartbeat(hb_path, interval=float(
                os.environ.get("PADDLE_RANK_HEARTBEAT_INTERVAL", "1.0")))
            self._hb_rank = os.environ.get(
                "RANK", os.environ.get("PADDLE_TRAINER_ID", "0"))
            self._hb.beat(phase="init", rank=self._hb_rank)
        try:
            return self._train_loop(resume)
        finally:
            if self._hb is not None:
                self._hb.close()
            self._restore_preemption_hook()

    def _train_loop(self, resume: bool):
        args = self.args
        start_step = self._try_resume() if resume else 0
        if self._hb is not None:
            # the resume marker
            self._hb.beat(force=True, phase="resumed", step=start_step,
                          rank=self._hb_rank)
        guard = bool(_fv("anomaly_guard"))
        self._anom_consec = 0
        self._anom_total = 0
        self._good_losses = deque(maxlen=20)
        meter = SpeedMeter(
            n_params=sum(p.numel() for p in self.model.parameters()),
            dtype="bfloat16" if args.bf16 else "float32")
        logs = []
        step = start_step
        loss = None
        loss_val = float("nan")
        save_owed = False       # a save boundary fell on an anomalous step
        pending = None          # (step, loss) awaiting its guard check
        data = self.data_iter_fn(start_step)
        t_start = time.perf_counter()
        for step in range(start_step, args.max_steps):
            # one trace per step: data / dispatch / loss-sync phases (all
            # host code around the step; no-ops with telemetry off)
            st_sp = _obs.start_span("train.step", parent=None,
                                    step=step + 1)
            if self._hb is not None:
                self._hb.beat(phase="step", step=step + 1,
                              rank=self._hb_rank)
            with _obs.span("train.data", parent=st_sp, step=step + 1):
                batch = next(data)
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            with _obs.span("train.dispatch", parent=st_sp, step=step + 1):
                loss = self._step_obj(*batch)
            if self.tokens_per_batch:
                meter.update(self.tokens_per_batch)
            log_b = (step + 1) % args.logging_steps == 0 or self._preempted
            save_b = (step + 1) % args.save_steps == 0 or self._preempted
            last_b = step == args.max_steps - 1
            step_anom = False
            if guard:
                # pipelined: the previous step's loss is read only after
                # this step is queued; boundaries check this step at once
                if pending is not None:
                    ps, pl = pending
                    pending = None
                    self._guard_check(ps, pl, parent=st_sp)
                if log_b or save_b or last_b:
                    step_anom = self._guard_check(step, loss, parent=st_sp)
                else:
                    pending = (step, loss)
            if log_b:
                if guard:
                    # the boundary check above already read this loss
                    loss_val = float(loss)
                else:
                    with _obs.span("train.loss_sync", parent=st_sp,
                                   step=step + 1):
                        loss_val = float(loss)
                rec = {"step": step + 1, "loss": round(loss_val, 6),
                       "tokens_per_sec": round(meter.tokens_per_sec, 2),
                       "mfu": round(meter.mfu, 4)}
                logs.append(rec)
                self._log(rec)
                if _obs.enabled():
                    if math.isfinite(loss_val):
                        _obs.gauge("train.loss").set(loss_val)
                    executed = step + 1 - start_step
                    _obs.gauge("robustness.goodput").set(
                        (executed - self._anom_total) / max(executed, 1))
                    _obs.maybe_export(step=step + 1)
            if step_anom and save_b:
                # never checkpoint an anomalous step: the save is owed to
                # the next verified-good step
                save_owed = True
                self._log({"checkpoint_skipped_at": step + 1,
                           "reason": "anomalous_step"})
            elif save_b or (save_owed and guard and not step_anom
                            and pending is None):
                self._save(step + 1)
                save_owed = False
            st_sp.end(anomalous=step_anom)
            if self._preempted:
                _obs.flight_dump(reason="preempted")
                self._log({"preempted_at": step + 1})
                break
        else:
            step = args.max_steps - 1
            if loss is not None:
                loss_val = float(loss)
        executed = max(step + 1 - start_step, 1)
        return {"start_step": start_step, "final_step": step + 1,
                "final_loss": loss_val,
                "wall_s": time.perf_counter() - t_start,
                "tokens_per_sec": meter.tokens_per_sec, "mfu": meter.mfu,
                "anomalous_steps": self._anom_total,
                "goodput": (executed - self._anom_total) / executed,
                "preempted": self._preempted, "logs": logs}

    def _log(self, rec: dict):
        logging.getLogger("paddle_tpu_torch.trainer").info("%s", rec)
