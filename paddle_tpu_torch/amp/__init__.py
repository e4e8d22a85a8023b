"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``).

The reference casts at its op dispatcher (``paddle_tpu/ops/_dispatch.py``
``apply``): every op carries a name, and under ``auto_cast`` the floating
inputs of a named op are cast to the dtype :func:`amp_dtype_for` gives
it. The port has no dispatcher, so the cast is :func:`cast_inputs`,
called at each counterpart of a reference site whose op name matters on
the ported paths: ``linear`` (``nn.functional.linear``,
``nn.layers_common.AmpLinear`` and the Llama projections), ``matmul``
(the tied LM heads), ``conv`` (``nn.functional.conv2d``), ``rms_norm``,
``layer_norm``, ``batch_norm``, ``softmax``, ``cross_entropy``,
``flash_attention``, and, cast at O2 only, ``embedding``, ``dropout``,
``gelu``, ``relu``, ``silu``, ``swiglu``, ``fused_rope``, ``max_pool``
and ``avg_pool``. So at O1 a ResNet's convolutions run in the amp dtype
and its BatchNorms in f32. An op the reference leaves unnamed (residual
adds, reshapes, ``tanh``, the adaptive pools) keeps its inputs' dtypes,
and torch promotes f32 + f16 to f32 as jax does.

``torch.autocast`` is not used: its cast lists are PyTorch's, and it does
not see the port's own ops (``fused_rms_norm``, ``fused_layer_norm``,
``flash_attention_bshd``).

The state is one per process, as the reference's: ``auto_cast`` sets it
and puts the previous state back on exit. ``snapshot`` / ``restored``
carry a state across the point where a recomputed forward runs again
(``distributed.fleet.recompute``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "is_float16_supported", "is_bfloat16_supported", "debugging",
           "is_autocast_enabled", "get_autocast_dtype", "amp_state",
           "amp_dtype_for", "cast_inputs"]

# the reference's lists, letter for letter
_WHITE_LIST = {
    "matmul", "linear", "conv", "flash_attention", "einsum", "bmm", "mm",
    "addmm",
}
_BLACK_LIST = {
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "cross_entropy", "exp", "log", "mean", "sum", "cumsum",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _convert_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"amp: unknown dtype {dtype!r}") from None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


class _AmpState:
    enabled = False
    dtype = torch.bfloat16
    level = "O1"
    custom_white = set()
    custom_black = set()


_state = _AmpState()
_FIELDS = ("enabled", "dtype", "level", "custom_white", "custom_black")


def amp_state():
    return _state


def snapshot() -> tuple:
    """The current state, for :func:`restored`."""
    return tuple(getattr(_state, f) for f in _FIELDS)


@contextlib.contextmanager
def restored(state: tuple):
    """Run under ``state`` (a :func:`snapshot`), then put back the state
    of the caller."""
    prev = snapshot()
    for f, v in zip(_FIELDS, state):
        setattr(_state, f, v)
    try:
        yield
    finally:
        for f, v in zip(_FIELDS, prev):
            setattr(_state, f, v)


def amp_dtype_for(op_name):
    """The dtype the floating inputs of ``op_name`` are cast to, or None
    to leave them alone: f32 for a black-listed op, the amp dtype for
    every named op at O2 and for a white-listed one at O1."""
    if not _state.enabled or not op_name:
        return None
    if op_name in _state.custom_black or op_name in _BLACK_LIST:
        return torch.float32
    if _state.level == "O2":
        return _state.dtype
    if op_name in _state.custom_white or op_name in _WHITE_LIST:
        return _state.dtype
    return None


def cast_inputs(op_name, *tensors):
    """``tensors`` as op ``op_name`` takes them under the current state:
    each floating tensor other than f64 cast to :func:`amp_dtype_for`'s
    dtype where it differs (the reference's ``apply``); None and other
    tensors unchanged. Returns a tuple."""
    if not _state.enabled:
        return tensors
    d = amp_dtype_for(op_name)
    if d is None:
        return tensors
    return tuple(
        t.to(d) if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.dtype != d and t.dtype != torch.float64) else t
        for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: the state for the ``with`` block."""
    with restored((bool(enable), _convert_dtype(dtype), level,
                   set(custom_white_list or ()),
                   set(custom_black_list or ()))):
        yield


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2, every floating parameter and buffer
    of each model is cast to ``dtype`` in place (the reference casts every
    float, norms included). The optimizers pass through: theirs keep f32
    master weights and moments for 16-bit parameters
    (``Optimizer._mp_active``), created at first use, so decorate before
    the first step."""
    d = _convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        for m in ms:
            m.to(dtype=d)
    if optimizers is None:
        return models if single else ms
    return (models, optimizers)


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


def is_autocast_enabled():
    """``paddle.amp.is_autocast_enabled``."""
    return bool(_state.enabled)


def get_autocast_dtype():
    """``paddle.get_autocast_dtype``: the amp dtype's name, or "float32"
    when autocast is off."""
    if not _state.enabled:
        return "float32"
    return _dtype_name(_state.dtype)


class debugging:
    """``paddle.amp.debugging``: ``check_numerics``,
    ``check_layer_numerics``, ``DebugMode`` and ``TensorCheckerConfig``.
    The operator-stats collection and the tensor checker hook the
    reference's op dispatcher, which the port has not."""

    @staticmethod
    def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
        """Raise ``FloatingPointError`` when ``tensor`` holds NaN or Inf
        (one host sync); return it otherwise."""
        t = torch.as_tensor(tensor)
        n_nan, n_inf = torch.stack([torch.isnan(t).sum(),
                                    torch.isinf(t).sum()]).tolist()
        if n_nan or n_inf:
            raise FloatingPointError(
                f"check_numerics({op_type}/{var_name}): {n_nan} NaN, "
                f"{n_inf} Inf values found")
        return t

    class DebugMode:
        """``paddle.amp.debugging.DebugMode``."""
        CHECK_NAN_INF_AND_ABORT = 0
        CHECK_NAN_INF = 1
        CHECK_ALL_FOR_OVERFLOW = 2
        CHECK_ALL = 3
        DUMP_ALL = 4

    class TensorCheckerConfig:
        """``paddle.amp.debugging.TensorCheckerConfig`` (its fields)."""

        def __init__(self, enable=True, debug_mode=None, output_dir=None,
                     checked_op_list=None, skipped_op_list=None,
                     debug_step=None, stack_height_limit=1):
            self.enable = enable
            self.debug_mode = debug_mode
            self.output_dir = output_dir

    @staticmethod
    def check_layer_numerics(func):
        """Decorator: ``check_numerics`` on each tensor the wrapped
        forward returns."""
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            for o in outs:
                if isinstance(o, torch.Tensor):
                    debugging.check_numerics(
                        o, op_type=getattr(func, "__qualname__", "layer"))
            return out
        return wrapper
