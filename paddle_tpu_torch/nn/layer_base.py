"""``paddle.nn.Layer`` (counterpart of ``paddle_tpu/nn/layer_base.py``): the
base class of every layer and model of the port, a ``torch.nn.Module``
with the reference's names, positional order and defaults.

Registries, attribute lookup, ``__call__`` and the forward hooks are
torch's own, so a module call costs what a ``torch.nn.Module`` call
costs. What differs from torch is the reference's surface:

- ``parameters()`` / ``buffers()`` / ``sublayers()`` return lists;
  ``named_parameters(prefix, include_sublayers)``, ``named_sublayers(
  prefix, include_self)``;
- ``register_buffer(name, tensor, persistable=True)``; ``add_parameter``,
  ``add_sublayer``, ``create_parameter`` (``nn.initializer.
  create_parameter`` with the layer's dtype as the default);
- ``state_dict(destination, include_sublayers, structured_name_prefix,
  use_hook)`` and ``set_state_dict`` / ``load_dict``, which write every
  matching entry in place (``copy_``: a parameter keeps its storage, so
  captured CUDA graphs and the prefix cache's version check see the
  load) and return ``(missing, unexpected)`` without raising; a shape
  mismatch raises ``ValueError``;
- ``register_forward_post_hook(hook(layer, inputs, outputs))`` (torch's
  forward hook), ``full_name()``, ``to(device, dtype, blocking)``,
  ``astype``, ``float16``, ``clear_gradients``.

Torch calls some of these methods itself with its own keywords
(``functional_call`` asks for ``named_parameters(remove_duplicate=False)``,
``Module.state_dict`` recurses with ``prefix=`` and ``keep_vars=``, a
torch container's ``train`` passes ``mode`` by position); those keywords
stay, keyword-only after the reference's parameters, and ``train`` keeps
torch's positional ``mode`` (the reference's ``train()`` takes none).

Unlike the reference, ``Linear.weight`` is stored [out, in] (torch's
layout); ``state_dict`` / ``set_state_dict`` use the port's layout, and
reference-layout arrays go through ``convert.load_reference_state_dict``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ..framework import dtype as dtypes
from .initializer import create_parameter as _create_parameter


class Layer(nn.Module):
    """A torch layer listed before ``Layer`` in a subclass's bases
    (``nn.Linear``, ``nn.ModuleList``) reaches ``Layer.__init__`` through
    its own ``super().__init__()``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    def full_name(self):
        return self._name_scope

    # ------------------------------------------------------- registration --
    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        """A parameter drawn as the reference's ``Layer.create_parameter``
        draws it (``nn.initializer.create_parameter``), of the layer's
        dtype unless ``dtype`` is given; None for ``attr=False``. The
        parameter is not registered (assign it to an attribute)."""
        d = dtypes.convert_dtype(dtype) if dtype is not None else self._dtype
        return _create_parameter(shape, attr, d, is_bias,
                                 default_initializer, device=device)

    # ---------------------------------------------------------- traversal --
    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix, include_sublayers,
                                        remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix, include_sublayers,
                                     remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False):
        """Pre-order (name, layer) pairs, as the reference walks them (a
        layer shared by two parents comes once under each)."""
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield sub, layer
            # unbound: a torch module below a Layer is walked the same way
            yield from Layer.named_sublayers(layer, sub)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -------------------------------------------------------------- modes --
    def train(self, mode=True):
        for m in self.modules():
            m.training = bool(mode)
        return self

    # -------------------------------------------------------------- hooks --
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)``; what it returns (a tuple, or one value)
        replaces the inputs. Returns a handle with ``remove()``."""
        return super().register_forward_pre_hook(hook)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; what it returns replaces the
        outputs. Returns a handle with ``remove()``."""
        return super().register_forward_hook(hook)

    # ----------------------------------------------------------- state io --
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """Parameters and persistable buffers by structured name, each
        layer's own before its sublayers' (the reference's order)."""
        if prefix is not None:
            structured_name_prefix = prefix
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=structured_name_prefix,
                                      keep_vars=keep_vars)
        dest = collections.OrderedDict() if destination is None \
            else destination
        self._save_to_state_dict(dest, structured_name_prefix, keep_vars)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` whose name this layer's state
        dict holds into that tensor, in place and cast to its dtype;
        returns ``(missing, unexpected)``, the reference's lists."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected, matched = [], [], set()
        for k, v in state_dict.items():
            t = own.get(k)
            if t is None:
                unexpected.append(k)
                continue
            src = v.detach() if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.asarray(v))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {k}: got {tuple(src.shape)}, "
                    f"expected {tuple(t.shape)}")
            t.copy_(src)
            matched.add(k)
        missing = [k for k in own if k not in matched]
        return missing, unexpected

    load_dict = set_state_dict

    # ---------------------------------------------------------- conversion --
    def to(self, device=None, dtype=None, blocking=None):
        """``to(device)``, ``to(dtype=...)`` or both (a dtype as the first
        argument, as torch takes it, is a dtype); floating parameters and
        buffers take the dtype."""
        if device is not None and dtypes.is_dtype(device):
            device, dtype = None, device
        if dtype is not None:
            self.astype(dtype)
        if device is not None:
            from ..framework.place import to_torch_device
            super().to(device=to_torch_device(device),
                       non_blocking=blocking is False)
        return self

    def astype(self, dtype):
        d = dtypes.convert_dtype(dtype)
        self._apply(lambda t: t.to(d) if t.is_floating_point() else t)
        self._dtype = d
        return self

    def float(self):
        return self.astype(torch.float32)

    def bfloat16(self):
        return self.astype(torch.bfloat16)

    def float16(self):
        return self.astype(torch.float16)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

