"""``paddle.jit.save`` / ``paddle.jit.load`` and ``InputSpec``
(counterpart of ``paddle_tpu/jit/api.py`` ``InputSpec``, ``save``,
``load``, ``TranslatedLayer`` and ``AOTLayer``).

``save(layer, path, input_spec)`` writes three files:
- ``path.pdiparams``: the state dict as a plain pickle of numpy arrays in
  the reference's names and [in, out] layout
  (``convert.export_reference_state_dict``), bf16 as uint16 bits listed
  in ``bf16_keys``; either package reads the other's;
- ``path.pdmodel``: the meta (class name, input specs, ``bf16_keys``);
- ``path.pt2``: the stand-in for the reference's ``.pdexec`` (StableHLO
  from ``jax.export``): a ``torch.export`` program of the layer's
  inference forward that takes the weights as inputs, so it ships no
  weight. ``None`` / ``-1`` dims of a spec become ``torch.export.Dim``;
  the non-persistent buffers (the RoPE tables) ship inside it, and the
  names, the transposed weights and the export device in its extra file
  ``paddle_meta.json``. The kernels appear in it as the custom ops
  ``paddle_tpu_torch::rms_norm`` / ``layer_norm`` / ``flash_fwd``, so a
  loaded program launches them on the card.

Where export fails (or no spec is given) ``save`` warns and writes the
weights and meta only, as the reference does. ``load`` runs a ``.pt2``
in a fresh process without the model's class and without a trace
(``AOTLayer``); otherwise it reloads a layer saved in this process
(``TranslatedLayer``). A ``.pt2`` loads under the torch that wrote it.
"""
from __future__ import annotations

import json
import os
import pickle
import warnings

import numpy as np
import torch
from torch import nn

from .. import convert, framework_io
from ..framework import resolve_device
# the kernels' custom ops must be registered before a program loads
from ..kernels import attention as _attention  # noqa: F401
from ..kernels import norm as _norm  # noqa: F401

__all__ = ["InputSpec", "save", "load", "TranslatedLayer", "AOTLayer"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool, "int8": torch.int8,
           "uint8": torch.uint8, "float64": torch.float64}
_META_FILE = "paddle_meta.json"


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


class InputSpec:
    """``paddle.static.InputSpec``: a shape (``None`` or -1 for a dim the
    program takes at any size), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def dynamic(self, j) -> bool:
        d = self.shape[j]
        return d is None or int(d) < 0


class _Program(nn.Module):
    """What is exported: ``forward(weights, inputs)`` runs ``layer`` with
    its persistent state replaced by ``weights`` (in ``w_names`` order)
    and its non-persistent buffers, held here, as constants. The layer
    itself is not registered, so its parameters stay out of the
    program."""

    def __init__(self, layer, w_names, const):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        self._w_names = list(w_names)
        self._c_names = list(const)
        for i, t in enumerate(const.values()):
            self.register_buffer(f"const{i}", t)

    def forward(self, weights, xs):
        tensors = dict(zip(self._w_names, weights))
        for i, n in enumerate(self._c_names):
            tensors[n] = getattr(self, f"const{i}")
        return torch.func.functional_call(self._layer, tensors, tuple(xs))


def _export_program(layer, path, input_spec):
    """Write ``path.pt2``: the program of ``layer``'s inference forward for
    inputs of ``input_spec`` (a dynamic dim is traced at size 2)."""
    state = layer.state_dict()
    w_names = list(state)
    const = {n: b for n, b in layer.named_buffers() if n not in state}
    dev = next(iter(state.values())).device if state else torch.device("cpu")
    xs, dyn = [], []
    for i, s in enumerate(input_spec):
        shape = [2 if s.dynamic(j) else int(d) for j, d in enumerate(s.shape)]
        xs.append(torch.zeros(shape, dtype=s.dtype, device=dev))
        dyn.append({j: torch.export.Dim(f"s{i}_{j}")
                    for j in range(len(s.shape)) if s.dynamic(j)} or None)
    weights = [state[n].detach() for n in w_names]
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(
                _Program(layer, w_names, const), (weights, xs),
                dynamic_shapes=([None] * len(weights), dyn))
    finally:
        layer.train(was_training)
    ep.example_inputs = None    # else the weights would ship as samples
    meta = {"w_names": w_names, "device": dev.type,
            "transposed": sorted(convert.linear_weights(layer) & set(state))}
    torch.export.save(ep, path + ".pt2",
                      extra_files={_META_FILE: json.dumps(meta)})


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: weights (``.pdiparams``), meta (``.pdmodel``)
    and, with an ``input_spec``, the exported program (``.pt2``). If the
    program cannot be exported, warns and writes weights and meta only;
    ``load`` in this process then rebuilds from the live layer."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = convert.export_reference_state_dict(layer, bf16_bits=True)
    meta = {
        "class": type(layer).__name__,
        "input_spec": [{"shape": s.shape, "dtype": _dtype_name(s.dtype),
                        "name": s.name} for s in (input_spec or [])],
        "bf16_keys": [k for k, v in layer.state_dict().items()
                      if v.dtype == torch.bfloat16],
    }
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(state, f, protocol=4)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)
    if os.path.exists(path + ".pt2"):
        os.remove(path + ".pt2")
    if input_spec:
        try:
            _export_program(layer, path, input_spec)
        except Exception as e:  # the reference warns and goes on too
            warnings.warn(
                f"jit.save: export failed ({type(e).__name__}: {e}); wrote "
                "weights and meta only: load() will need the model in this "
                "process")
    _saved_layers[os.path.abspath(path)] = layer


_saved_layers = {}


def read_params(path, meta=None) -> dict:
    """``path.pdiparams`` as {name: tensor} in the reference's layout,
    bf16 restored from the ``bf16_keys`` of ``meta`` (``path.pdmodel``
    when not given)."""
    if meta is None:
        with open(path + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
    return framework_io.load(path + ".pdiparams",
                             bf16_keys=meta.get("bf16_keys", ()))


class TranslatedLayer:
    """``paddle.jit.load``'s result for a layer saved in this process: its
    weights reloaded from ``.pdiparams``, called without grad."""

    def __init__(self, layer, meta):
        self._layer = layer
        self._meta = meta

    def __call__(self, *args, **kw):
        with torch.no_grad():
            return self._layer(*args, **kw)

    def eval(self):
        self._layer.eval()
        return self

    def state_dict(self):
        return self._layer.state_dict()


class AOTLayer:
    """A loaded ``.pt2`` program: a callable inference layer that needs
    neither the model's class nor a trace. Weights come from
    ``.pdiparams`` (the linear ones transposed back to the port's
    [out, in]), placed on ``device`` (``cuda`` unless given; the program
    must have been exported on the same kind of device)."""

    def __init__(self, path, meta, device=None):
        self._meta = meta
        self.device = resolve_device(device)
        extra = {_META_FILE: ""}
        ep = torch.export.load(path + ".pt2", extra_files=extra)
        prog = json.loads(extra[_META_FILE])
        if prog["device"] != self.device.type:
            raise ValueError(
                f"{path}.pt2 was exported on {prog['device']}; load it on "
                f"that device, not {self.device}")
        state = read_params(path, meta)
        transposed = set(prog["transposed"])
        self._weights = [
            (state[n].t() if n in transposed else state[n]).contiguous()
            .to(self.device) for n in prog["w_names"]]
        self._names = prog["w_names"]
        self._module = ep.module().to(self.device)

    def __call__(self, *args):
        xs = [a.to(self.device) if isinstance(a, torch.Tensor)
              else torch.as_tensor(np.asarray(a), device=self.device)
              for a in args]
        with torch.no_grad():
            return self._module(self._weights, xs)

    def eval(self):
        return self

    def state_dict(self):
        return dict(zip(self._names, self._weights))


def load(path, device=None, **configs):
    """``paddle.jit.load``: the exported program (``.pt2``) when there is
    one, which runs in a fresh process without the model's class; else
    the layer saved under ``path`` in this process, with the weights of
    ``.pdiparams``."""
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    if os.path.exists(path + ".pt2"):
        return AOTLayer(path, meta, device)
    layer = _saved_layers.get(os.path.abspath(path))
    if layer is not None:
        convert.load_reference_state_dict(layer, read_params(path, meta))
        return TranslatedLayer(layer, meta)
    raise RuntimeError(
        "paddle_tpu_torch.jit.load: no exported program (.pt2) and the "
        "layer was not saved in this process; save with input_spec to get "
        "a standalone program, or use inference.Config.set_model_factory")
