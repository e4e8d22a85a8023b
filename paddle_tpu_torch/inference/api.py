"""The Paddle Inference API (counterpart of ``paddle_tpu/inference/
__init__.py`` ``PrecisionType``, ``PlaceType``, ``Config``, the zero-copy
handles, ``Predictor``, ``create_predictor`` and
``convert_to_mixed_precision``).

A ``Predictor`` runs either an artifact of ``jit.save`` (``prog_file``:
the exported ``.pt2`` program, loaded without the model's class, or a
layer saved in this process) or ``Config.set_model_factory``'s layer
with the weights of ``params_file``: a ``framework_io.save`` file (the
port's layout) or a ``.pdiparams`` (the reference's layout; bf16 from
the ``bf16_keys`` of the ``.pdmodel`` beside it). Inputs are named
``x0`` ... ``x7`` and outputs ``out0`` ...; bf16 and half precision cast
the layer to bf16, as the reference does. It runs on ``cuda`` unless
``Config.disable_gpu()``, and raises without a GPU.

Where the reference compiles one program per input signature
(``tuple((tuple(shape), str(dtype)) for each feed)``), the port keeps one
CUDA graph per signature, on either route: the first call of a
signature runs eagerly (its result is returned) and is captured
(``framework.graphs``, on the device's capture stream, over the
Predictors' graph pool); later calls copy the feeds into the graph's
static inputs and replay it. A graph reads the weights by address, so a
weight loaded in place is served by the next replay, and a rebound
weight (another tensor or storage) re-captures the signature. On the CPU
every call runs eagerly. ``Predictor.graph_stats`` counts captures,
replays, re-captures and capture seconds.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import convert, framework_io
from ..framework import resolve_device


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "gpu"  # parity alias: the port's accelerator is the GPU


class Config:
    """``paddle_infer.Config``."""

    def __init__(self, prog_file=None, params_file=None):
        self.prog_file = prog_file
        self.params_file = params_file
        self._model_dir = None
        self._precision = PrecisionType.Float32
        self._device = PlaceType.GPU
        self._device_id = 0
        self._enable_memory_optim = True
        self._compile_cache_dir = None
        self._model_factory: Optional[Callable] = None

    def set_model(self, prog_file, params_file=None):
        self.prog_file = prog_file
        self.params_file = params_file

    def set_prog_file(self, f):
        self.prog_file = f

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device = PlaceType.GPU
        self._device_id = device_id
        self._precision = precision

    enable_use_tpu = enable_use_gpu

    def disable_gpu(self):
        self._device = PlaceType.CPU

    def enable_xla(self, precision=PrecisionType.Float32):
        self._precision = precision

    def enable_tensorrt_engine(self, *args, **kwargs):
        # no TensorRT here: record the precision, as the reference does
        precision = kwargs.get("precision_mode")
        if precision:
            self._precision = precision

    def enable_memory_optim(self, x=True):
        self._enable_memory_optim = x

    def set_cpu_math_library_num_threads(self, n):
        pass

    def switch_ir_optim(self, x=True):
        pass

    def enable_compile_cache(self, cache_dir):
        self._compile_cache_dir = cache_dir

    def set_model_factory(self, factory: Callable):
        """A callable returning the module whose weights ``params_file``
        holds (in place of deserializing a program)."""
        self._model_factory = factory


class _IOHandle:
    """A zero-copy handle: an input's ``copy_from_cpu`` or an output's
    ``copy_to_cpu`` (bf16 comes out as float32)."""

    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def reshape(self, shape):
        pass

    def copy_from_cpu(self, arr: np.ndarray):
        self._p._feeds[self.name] = self._p._to_device(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return _to_numpy(self._p._outputs[self.name])

    def share_external_data(self, data):
        self.copy_from_cpu(np.asarray(data))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _load_params(layer, params_file):
    """Weights of ``params_file`` into ``layer``: a ``framework_io.save``
    file holds the port's state dict and loads through
    ``layer.set_state_dict``, as the reference's Predictor loads it (the
    entries that match are written in place; the missing / unexpected
    lists it returns are dropped there too); a plain pickle
    (``.pdiparams``) holds the reference's layout."""
    raw = framework_io.load_raw(params_file)
    bf16 = ()
    base = os.path.splitext(params_file)[0]
    if os.path.exists(base + ".pdmodel"):
        with open(base + ".pdmodel", "rb") as f:
            bf16 = pickle.load(f).get("bf16_keys", ())
    state = framework_io.restore(raw, bf16_keys=bf16)
    if framework_io.holds_payloads(raw):
        layer.set_state_dict(state)
    else:
        convert.load_reference_state_dict(layer, state)


class Predictor:
    """Runs a loaded model per call (``run(inputs)`` or through the
    handles), one CUDA graph per input signature on the card (see the
    module's docstring)."""

    def __init__(self, config: Config):
        self._config = config
        self._feeds = {}
        self._outputs = {}
        self._layer = None
        self._aot = None
        self._graphs = {}     # input signature -> graphs.Captured
        self.graph_stats = {"captures": 0, "replays": 0, "recaptures": 0,
                            "capture_s": 0.0}
        dev = None if config._device == PlaceType.GPU else "cpu"
        if dev is None and config._device_id:
            dev = f"cuda:{config._device_id}"
        self.device = resolve_device(dev)
        self._load()

    def _load(self):
        from ..jit import api as jit_api
        cfg = self._config
        if cfg._model_factory is not None:
            self._layer = cfg._model_factory().to(self.device)
            if cfg.params_file and os.path.exists(cfg.params_file):
                _load_params(self._layer, cfg.params_file)
        elif cfg.prog_file:
            base = cfg.prog_file[:-8] if cfg.prog_file.endswith(".pdmodel") \
                else cfg.prog_file
            if os.path.exists(base + ".pt2"):
                # the exported program: a fresh process loads it without
                # the model's class and without a trace
                with open(base + ".pdmodel", "rb") as f:
                    meta = pickle.load(f)
                self._aot = jit_api.AOTLayer(base, meta, self.device)
                self._layer = self._aot
            else:
                self._layer = jit_api._saved_layers.get(os.path.abspath(base))
        if self._layer is None:
            raise RuntimeError(
                "Predictor needs a jit.save'd program (.pt2), "
                "config.set_model_factory(...), or a layer jit.save'd in "
                "this process")
        self._layer.eval()
        if cfg._precision in (PrecisionType.Bfloat16, PrecisionType.Half) \
                and isinstance(self._layer, torch.nn.Module):
            self._layer.to(torch.bfloat16)
        self._input_names = ["x%d" % i for i in range(8)]

    def _to_device(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def get_input_names(self) -> List[str]:
        return self._input_names

    def get_input_handle(self, name) -> _IOHandle:
        return _IOHandle(self, name, True)

    def get_output_names(self) -> List[str]:
        return list(self._outputs.keys()) or ["out0"]

    def get_output_handle(self, name) -> _IOHandle:
        return _IOHandle(self, name, False)

    def _baked(self):
        """The tensors a captured graph reads by address: the layer's
        parameters and buffers (for an exported program, its weight
        list and its module's own tensors)."""
        lay = self._layer
        if isinstance(lay, torch.nn.Module):
            return [*lay.parameters(), *lay.buffers()]
        m = lay._module
        return [*lay._weights, *m.parameters(), *m.buffers()]

    def _call(self, feeds):
        """The layer on ``feeds`` (device tensors): eager on the CPU; on
        CUDA the signature's graph, captured at its first call (which runs
        eagerly) and re-captured when a weight was rebound."""
        from ..framework.graphs import (Captured, GraphProgram,
                                        capture_stream, graph_pool)
        dev = self.device
        with torch.no_grad():
            if dev.type != "cuda":
                return self._layer(*feeds)
            sig = tuple((tuple(a.shape), str(a.dtype)) for a in feeds)
            baked = self._baked()
            entry = self._graphs.get(sig)
            if entry is not None and not entry.reads(baked):
                # the graph would read the old storage: capture again
                del self._graphs[sig]
                entry = None
                self.graph_stats["recaptures"] += 1
            if entry is not None:
                self.graph_stats["replays"] += 1
                return entry.program(*feeds)
            out = self._layer(*feeds)
            t0 = time.perf_counter()
            program = GraphProgram(self._layer, tuple(feeds),
                                   graph_pool(dev, "predictor"),
                                   capture_stream(dev))
            self.graph_stats["capture_s"] += time.perf_counter() - t0
            self.graph_stats["captures"] += 1
            self._graphs[sig] = Captured(program, baked)
            return out

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """With ``inputs``, returns the outputs as numpy arrays; without,
        runs on the handles' feeds and returns True. Both reach the same
        per-signature graphs."""
        if inputs is not None:
            feeds = [self._to_device(a) for a in inputs]
        else:
            feeds = [self._feeds[k] for k in
                     sorted(self._feeds, key=self._input_names.index)]
        out = self._call(feeds)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self._outputs = {f"out{i}": o for i, o in enumerate(outs)}
        if inputs is not None:
            return [_to_numpy(o) for o in outs]
        return True


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def convert_to_mixed_precision(*args, **kwargs):
    raise NotImplementedError("use Config.enable_xla(precision=...) instead")
